"""The port's serving telemetry against the JAX package's
(``dinov3_tpu/telemetry``): histograms, the live-mix envelope, the
observer's records, the span tracer and watchdog files, the counted fetch
funnel, and the serve span stream read by ``scripts/obs_report.py``.

All comparisons are exact (bitwise for the numbers, equal for the
records) except where a record carries a time read off the host clock:
those fields (``t``, window ``dur_ms``, ``enqueue_ms``) are masked.
JAX and the JAX package are imported inside the tests.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# host-clock fields of the span records
CLOCK_FIELDS = ("t", "enqueue_ms")


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(rec: dict) -> dict:
    out = {k: v for k, v in rec.items() if k not in CLOCK_FIELDS}
    if out.get("name") in ("serve_window", "stall"):
        out.pop("dur_ms", None)
    return out


def _records(path) -> list:
    with open(path) as f:
        return [_masked(json.loads(line)) for line in f if line.strip()]


# ---------------- histograms ----------------

SAMPLES = {
    "lognormal": np.random.default_rng(0).lognormal(1.0, 1.2, 5000),
    "tight": np.random.default_rng(1).normal(20.0, 0.5, 777),
    "out_of_range": np.concatenate([[0.0, -1.0, 1e-5, 3e6],
                                    np.random.default_rng(2).uniform(1, 50, 300)]),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_log_histogram_equals_jax(name):
    """Same samples -> the same ``to_dict``, quantiles and summary
    (exact); a merge of two halves equals JAX's merge and the whole."""
    from dinov3_tpu.telemetry.hist import LogHistogram as JHist

    from dinov3_tpu_torch.telemetry import LogHistogram

    xs = SAMPLES[name]
    h, j = LogHistogram(), JHist()
    h.observe_many(xs)
    j.observe_many(xs)
    assert h.to_dict() == j.to_dict()
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == j.quantile(q), q
    assert h.summary() == j.summary()
    a, b = LogHistogram(), LogHistogram()
    ja, jb = JHist(), JHist()
    for hist, part in ((a, xs[::2]), (b, xs[1::2]), (ja, xs[::2]), (jb, xs[1::2])):
        hist.observe_many(part)
    merged = a.merge(b)
    assert merged.to_dict() == ja.merge(jb).to_dict()
    assert np.array_equal(merged.counts, h.counts)
    assert LogHistogram.from_dict(j.to_dict()).to_dict() == j.to_dict()


def test_quantile_nearest_rank_equals_jax():
    from dinov3_tpu.telemetry.hist import quantile_nearest_rank as jq

    from dinov3_tpu_torch.telemetry import quantile_nearest_rank

    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 100, 1001):
        vals = sorted(rng.exponential(5.0, n).tolist())
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert quantile_nearest_rank(vals, q) == jq(vals, q), (n, q)
    with pytest.raises(ValueError):
        quantile_nearest_rank([], 0.5)


# ---------------- live mix and envelope ----------------

def _layout(**kw):
    from dinov3_tpu_torch.serve import ServeLayout

    base = dict(rows=4, row_tokens=2050, n_prefix=1, max_segments_per_row=8,
                patch_size=16, in_chans=3, normalize="separate", min_px=96,
                max_px=512)
    base.update(kw)
    return ServeLayout(**base)


def _j_layout(**kw):
    import dataclasses

    from dinov3_tpu.serve import ServeLayout as JLayout

    return JLayout(**dataclasses.asdict(_layout(**kw)))


def test_simulated_ffd_waste_equals_jax():
    from dinov3_tpu.telemetry.serve_obs import simulated_ffd_waste as jw

    from dinov3_tpu_torch.telemetry import simulated_ffd_waste

    rng = np.random.default_rng(4)
    for _ in range(20):
        lens = rng.integers(37, 1026, rng.integers(0, 80)).tolist()
        row, segs = int(rng.integers(1025, 4100)), int(rng.integers(1, 12))
        assert simulated_ffd_waste(lens, row, segs) == jw(lens, row, segs)


def test_live_mix_envelope_equals_jax():
    """The same request and pack stream over three windows: window
    summaries, EWMA state, drift messages and the recommended envelope
    all equal."""
    from dinov3_tpu.telemetry.serve_obs import LiveMixTracker as JTracker

    from dinov3_tpu_torch.telemetry import LiveMixTracker

    port, ref = LiveMixTracker(_layout()), JTracker(_j_layout())
    rng = np.random.default_rng(5)
    for _ in range(3):
        for _ in range(60):
            h, w = (16 * int(v) for v in rng.integers(6, 33, 2))
            for t in (port, ref):
                t.observe_request(_layout().seq_len(h, w), h, w)
        for _ in range(4):
            used = int(rng.integers(4000, 8200))
            for t in (port, ref):
                t.observe_pack(used, 8200)
        assert port.roll() == ref.roll()
    assert port.ewma_lens == ref.ewma_lens
    assert port.ewma_pad_waste == ref.ewma_pad_waste
    for thr in (0.05, 0.15, 0.5):
        assert port.recommended_serve_envelope(threshold=thr) == \
            ref.recommended_serve_envelope(threshold=thr)
        assert port.check_drift(threshold=thr, warn=False) == \
            ref.check_drift(threshold=thr, warn=False)


# ---------------- the observer ----------------

def _drive_observer(obs, rng):
    """One fixed sequence of hook calls: admissions, packs with given
    phase times and stats rows, routes, cache events, latencies."""
    layout = obs.layout
    rid = 0
    for pack in range(5):
        placements = []
        for _ in range(int(rng.integers(1, 6))):
            h, w = (16 * int(v) for v in rng.integers(6, 33, 2))
            slo = "interactive" if max(h, w) <= 304 else "batch"
            obs.on_admit(rid, slo, layout.seq_len(h, w), h, w)
            placements.append((rid, slo, layout.seq_len(h, w)))
            rid += 1
        used = sum(p[2] for p in placements)
        phases = {"placement": 0.25 * pack, "dispatch": 1.5, "device": 30.125,
                  "fetch": 30.125, "extract": 0.0625 if pack % 2 else None}
        stats = None if pack == 3 else {
            "tokens_used": float(used), "n_segments": float(len(placements)),
            "pad_tokens": float(layout.token_budget - used), "stamp": float(pack)}
        obs.on_pack(placements, phases, device_stats=stats, tokens_used=used,
                    token_budget=None if pack != 4 else 9000)
        for p in placements:
            obs.observe_latency(p[1], 0.001 * (p[0] + 1) ** 1.5, p[0])
    obs.on_route("fast", "interactive")
    obs.on_route("full", "batch")
    for event in ("miss", "insert", "hit", "evict"):
        obs.on_cache(event, request_id=7, slo="interactive", engine="fast")


def test_serve_observer_records_equal_jax(tmp_path):
    """The same hook calls into the port's and JAX's ``ServeObserver``:
    equal span records (clock fields masked), equal ``finalize()``
    summaries and histogram states, role-namespaced files and
    heartbeats."""
    from dinov3_tpu.telemetry.serve_obs import ServeObserver as JObserver
    from dinov3_tpu.telemetry.spans import SpanTracer as JTracer

    from dinov3_tpu_torch.telemetry import ServeObserver, SpanTracer

    out = {}
    for side, obs_cls, tracer_cls, layout in (
            ("port", ServeObserver, SpanTracer, _layout()),
            ("jax", JObserver, JTracer, _j_layout())):
        tracer = tracer_cls(str(tmp_path / side), role="serve")
        obs = obs_cls(tracer, layout, slo_classes=("interactive", "batch"),
                      window_packs=2, warn=False)
        obs.set_labels(arm="packed", mix="m", nothing=None)
        _drive_observer(obs, np.random.default_rng(6))
        fin = obs.finalize()
        tracer.close()
        out[side] = (fin, _records(tracer.spans_path),
                     sorted(os.listdir(tmp_path / side / "telemetry")),
                     {s: h.to_dict() for s, h in obs.hists.items()})
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0] == out["jax"][0]
    assert out["port"][2] == out["jax"][2] == ["heartbeat.serve",
                                               "spans.serve.jsonl"]
    assert out["port"][3] == out["jax"][3]
    names = {r["name"] for r in out["port"][1]}
    assert {"serve_request", "serve_pack_stats", "serve_window", "serve_hist",
            "serve_mix", "serve_cache", "serve_latency"} <= names


# ---------------- span tracer and watchdog ----------------

def test_span_tracer_files_roles_and_heartbeats_equal_jax(tmp_path):
    """Both tracers over the same calls (two roles, two ranks, spans,
    auto-flush, beats): the same files, the same records with the clock
    fields masked; the heartbeat scan and reads agree."""
    import time

    from dinov3_tpu.telemetry.spans import SERVE_PHASES as J_SERVE
    from dinov3_tpu.telemetry.spans import SPAN_SCHEMA_V as J_V
    from dinov3_tpu.telemetry.spans import SpanTracer as JTracer
    from dinov3_tpu.telemetry.watchdog import read_heartbeat as j_read
    from dinov3_tpu.telemetry.watchdog import scan_heartbeats as j_scan

    from dinov3_tpu_torch.telemetry import (
        PHASES,
        SERVE_PHASES,
        SPAN_SCHEMA_V,
        SpanTracer,
        read_heartbeat,
        scan_heartbeats,
    )
    from dinov3_tpu_torch.telemetry.spans import PHASES as P2

    from dinov3_tpu.telemetry.spans import PHASES as J_PHASES

    assert SERVE_PHASES == J_SERVE and SPAN_SCHEMA_V == J_V
    assert PHASES == P2 == J_PHASES
    now = time.time()
    for side, cls in (("port", SpanTracer), ("jax", JTracer)):
        for role, rank in (("train", 0), ("serve", 0), ("serve", 1)):
            tr = cls(str(tmp_path / side), rank=rank, role=role,
                     flush_every_emits=3, heartbeat_every=2)
            for i in range(5):
                with tr.span("dispatch", i, pack=i):
                    pass
                tr.emit({"name": "custom", "i": i})
                tr.beat(i)
            for _ in tr.wrap_iter(range(2)):
                pass
            tr.close()
        (tmp_path / side / "telemetry" / "heartbeat.rank3").write_text("{}")
        # a disabled tracer writes nothing
        off = cls(str(tmp_path / side / "off"), enabled=False)
        off.emit({"name": "x"})
        off.beat(0)
        assert not (tmp_path / side / "off").exists()

    files = {s: sorted(os.listdir(tmp_path / s / "telemetry")) for s in ("port", "jax")}
    assert files["port"] == files["jax"]
    for name in files["port"]:
        if name.startswith("spans"):
            got = _records(tmp_path / "port" / "telemetry" / name)
            want = _records(tmp_path / "jax" / "telemetry" / name)
            for rec in got + want:
                rec.pop("dur_ms", None)
            assert got == want, name

    def scan(fn, side):
        return [{k: v for k, v in r.items() if k not in ("path", "mtime", "age_s")}
                for r in fn(str(tmp_path / side), stale_after_s=3600.0, now=now)]

    assert scan(scan_heartbeats, "port") == scan(j_scan, "jax")
    for role, rank in (("serve", 1), ("train", 0), ("train", 3), ("none", 0)):
        got = read_heartbeat(str(tmp_path / "port"), role, rank)
        want = j_read(str(tmp_path / "jax"), role, rank)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got["iteration"], got["legacy"]) == (want["iteration"], want["legacy"])


def test_watchdog_stall_span_equals_jax(tmp_path):
    import time

    from dinov3_tpu.telemetry.spans import SpanTracer as JTracer
    from dinov3_tpu.telemetry.watchdog import Watchdog as JWatchdog

    from dinov3_tpu_torch.telemetry import SpanTracer, Watchdog

    recs = {}
    for side, tcls, wcls in (("port", SpanTracer, Watchdog), ("jax", JTracer, JWatchdog)):
        tr = tcls(str(tmp_path / side), role="serve")
        wd = wcls(tr, deadline_s=0.001)
        with wd.window("flush", pack=1):
            time.sleep(0.005)
        with wd.window("fast", deadline_s=10.0):
            pass
        with wd.window("off", deadline_s=0.0):
            time.sleep(0.002)
        assert wd.stalls == 1
        tr.close()
        recs[side] = _records(tr.spans_path)
    assert recs["port"] == recs["jax"] == [
        {"name": "stall", "window": "flush", "deadline_ms": 1.0, "pack": 1,
         "v": 1, "role": "serve"}]


def test_profiler_window_and_memory_sample(tmp_path):
    """The profiler window opens at its first iteration and closes at its
    last, exporting a gzipped chrome trace that ``load_trace`` reads with
    the window's step annotations; the window's records and a memory
    record ride the stream (no device on the CPU)."""
    from dinov3_tpu_torch.telemetry import SpanTracer, find_trace_file, load_trace

    tr = SpanTracer(str(tmp_path), profile_steps=(1, 2),
                    profile_dir=str(tmp_path / "trace"))
    for it in range(4):
        tr.profile_step_begin(it)
        with tr.step_annotation(it):
            torch.ones(8, 8) @ torch.ones(8, 8)
        assert (tr.profile_step_end(it) is not None) == (it == 2)
    tr.emit_memory("setup", 0)
    tr.close()
    recs = _records(tr.spans_path)
    assert [(r["name"], r["iteration"]) for r in recs] == [
        ("profile_start", 1), ("profile_stop", 2), ("memory", 0)]
    assert recs[1]["trace_path"] == find_trace_file(str(tmp_path / "trace"))
    trace = load_trace(recs[1]["trace_path"])
    names = {e.name for e in trace.events if e.cat == "user_annotation"}
    assert {"train_step#1", "train_step#2"} <= names and "train_step#0" not in names
    # the warm-up's schedule adds no ProfilerStep#N over the window's steps
    assert not any(n.startswith("ProfilerStep#") for n in names), names
    assert recs[2]["point"] == "setup"
    assert recs[2]["devices"] == ([] if not torch.cuda.is_available() else recs[2]["devices"])


# ---------------- the fetch funnel ----------------

def test_blocking_fetch_counts_one_call_a_fetch():
    from dinov3_tpu_torch.telemetry import blocking_fetch, host_sync_stats

    host_sync_stats(reset=True)
    a, b = torch.arange(6.0).view(2, 3), torch.ones(4)
    one = blocking_fetch(a)
    pair = blocking_fetch((a, b))
    stats = host_sync_stats(reset=True)
    assert stats["fetches"] == 2 and stats["blocked_ms"] >= 0.0
    assert host_sync_stats()["fetches"] == 0
    assert torch.equal(one, a) and torch.equal(pair[0], a) and torch.equal(pair[1], b)
    with pytest.raises(ValueError, match="one dtype"):
        blocking_fetch((a, torch.arange(3)))


# ---------------- the span stream through the reference's reader ----------------

SERVE_SMOL = [
    "student.arch=vit_test", "student.patch_size=4",
    "serve.min_px=8", "serve.max_px=24", "serve.rows=3",
    "serve.row_tokens=40", "serve.max_segments_per_row=6",
]


@pytest.fixture(scope="module")
def smol_model():
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.serve import load_serving_model, serve_layout_from_cfg

    cfg = get_default_config()
    apply_dot_overrides(cfg, SERVE_SMOL)
    return cfg, load_serving_model(cfg, device="cpu", seed=3), serve_layout_from_cfg(cfg)


def test_serve_span_stream_passes_obs_report(tmp_path, smol_model):
    """Each arm measured as the bench measures it, one span stream:
    ``scripts/obs_report.py`` validates the schema, finds a phase record
    for every measured request, and puts each SLO class's histogram
    p50/p99 within one bucket width of the exact ones; on the packed arm
    the fetches equal the observer's packs (one fetch a pack)."""
    from dinov3_tpu_torch.configs.config import serve_obs_kwargs
    from dinov3_tpu_torch.serve import OracleServeEngine, PackedServeEngine
    from dinov3_tpu_torch.serve.bench import (
        MIXES_SMOKE,
        _serve_summary,
        drain_all,
        make_mix,
        measure_arm,
    )
    from dinov3_tpu_torch.telemetry import ServeObserver, SpanTracer

    obs_report = _load_script("obs_report")
    cfg, model, layout = smol_model
    bands = [(0.7, (8, 12)), (0.3, (16, 24))]
    rng = np.random.default_rng(0)
    warm, meas = make_mix(rng, bands, 10, 4), make_mix(rng, bands, 12, 4)
    tracer = SpanTracer(str(tmp_path), role="serve")
    assert MIXES_SMOKE["mixed_ragged"]
    records = {}
    trace = None
    for arm, eng in (("packed", PackedServeEngine(model, layout, warn=False)),
                     ("oracle_rectangular", OracleServeEngine(model, layout)),
                     ("oracle_per_image", OracleServeEngine(model, layout,
                                                            mode="per_image"))):
        if trace is None:
            wall, _ = drain_all(eng, warm)
            arrivals = np.cumsum(rng.exponential(wall / len(warm) / 0.7, len(meas)))
            trace = [(float(a), im) for a, im in zip(arrivals, meas)]
        obs = ServeObserver(tracer, layout, slo_classes=("interactive", "batch"),
                            **serve_obs_kwargs(cfg))
        obs.set_labels(arm=arm, mix="m")
        rec, _ = measure_arm(eng, warm, meas, trace, _serve_summary,
                             lambda w: None, observer=obs)
        records[arm] = rec
        if arm == "packed":
            assert rec["serve"]["host_sync"]["fetches"] == rec["serve"]["obs"]["packs"]
    tracer.close()
    spans, census = obs_report.load_spans(tracer.spans_path)
    assert census["by_name"]["serve_request"] == 3 * 2 * len(meas)
    for arm, rec in records.items():
        reqs = [r for r in spans if r["name"] == "serve_request" and r["arm"] == arm]
        obs_report.check_requests(reqs, 2 * len(meas), arm)
        rows = obs_report.hist_vs_exact(rec["serve"]["obs"]["slo"],
                                        rec["latency"]["by_slo"], arm)
        assert set(rows) == set(rec["latency"]["by_slo"]) and rows
        breakdown = obs_report.phase_breakdown(reqs)
        assert breakdown["device_ms"]["n"] == 2 * len(meas)
