"""The serving bench (``scripts/bench_serve.py``): the packed engine
against the naive oracles, and the int8 / fleet / cache plane.

    python -m dinov3_tpu_torch.serve.bench [--smoke] [--fleet] [--n N]
        [--seed S] [--out PATH] [--obs-dir DIR] [--device cpu|cuda]
        [key=value ...]

Method (the reference's):

- **Traffic**: seeded draws of [H, W, 3] requests from banded mixes:
  ``uniform_224``, ``mixed_ragged`` (H and W drawn independently on the
  patch grid across 96..512 px bands, small-skewed: hundreds of (H, W)
  pairs) and ``heavy_tail`` (90 % small crops, 10 % near-max).
- **Arms over identical traffic**: the packed engine and the two
  oracles (``oracle_rectangular``: group by shape, batch padded to a
  power of two; ``oracle_per_image``: one forward a request), the same
  bf16 model and batcher policy. Each arm first serves a disjoint warm-up
  draw; shapes it has not seen afterwards count as measured cost
  (``compile_growth_during_measurement``).
- **Throughput**: all measured requests arrive at t=0; img/s is N over
  the drain's wall seconds.
- **Latency**: a virtual-clock replay of Poisson arrivals at 0.7 x the
  packed arm's sustained rate, the same trace for every arm. The clock
  advances by each flush's measured wall time, so an arm slower than the
  offered rate queues; p50/p99 are exact nearest-rank over per-request
  ``done_s - arrival_s``, overall and per SLO class, beside the
  observer's streaming histograms.
- **Fleet** (``--fleet``): an int8-vs-bf16 A/B on one draw (drift probe,
  best of k alternated drains, feature agreement), then a 2-engine fleet
  (an int8 fast lane whose envelope is derived from the measured
  interactive mix, next to the full bf16 row) behind the admission layer
  with the feature cache in front, replayed at cache hit rates {0, 0.5,
  0.9}, every hit compared bitwise with its miss.

Writes one JSON record (the reference's keys; the HLO copy and collective
census of the reference's compiled program has no counterpart here and is
left out) and prints it. ``--smoke`` runs a ViT-S/4 at 8..32 px (head
dim 64, which the card's attention kernel takes) in seconds, on the CPU
(``--device cpu``) or the card.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

# ---------------- traffic mixes ----------------
#
# (probability, (min_px, max_px)) bands; H and W are drawn independently
# on the patch grid inside the band

MIXES_FULL = {
    "uniform_224": [(1.0, (224, 224))],
    "mixed_ragged": [(0.70, (96, 256)), (0.20, (208, 320)),
                     (0.10, (336, 512))],
    "heavy_tail": [(0.90, (96, 160)), (0.10, (448, 512))],
}

MIXES_SMOKE = {
    "uniform_224": [(1.0, (16, 16))],
    "mixed_ragged": [(0.70, (8, 16)), (0.20, (20, 24)), (0.10, (28, 32))],
    "heavy_tail": [(0.90, (8, 12)), (0.10, (28, 32))],
}

# the reference's smoke layout, with an arch whose head dim (64) the
# card's attention kernel takes (vit_test's is 32)
SMOKE_OVERRIDES = [
    "student.arch=vit_small", "student.patch_size=4",
    "serve.min_px=8", "serve.max_px=32", "serve.rows=4",
    "serve.row_tokens=65", "serve.max_segments_per_row=12",
]
# the full run: one max-envelope image per row, slots for a row of 96 px
# requests (27 fit)
FULL_OVERRIDES = [
    "student.arch=vit_small", "serve.rows=4", "serve.row_tokens=1025",
    "serve.max_segments_per_row=28",
]


def make_mix(rng: np.random.Generator, bands, n: int, grid: int) -> list:
    """n seeded [H, W, 3] float32 images from the banded distribution."""
    probs = np.array([p for p, _ in bands])
    out = []
    for b in rng.choice(len(bands), size=n, p=probs / probs.sum()):
        lo, hi = bands[int(b)][1]
        sizes = np.arange(lo, hi + 1, grid)
        h, w = rng.choice(sizes), rng.choice(sizes)
        out.append(rng.standard_normal((int(h), int(w), 3))
                   .astype(np.float32))
    return out


def slo_class(image, layout) -> str:
    """Small requests (both sides at or below the envelope's midpoint)
    are ``interactive``, larger ones ``batch``: size-derived, so every
    arm serves the same class per request."""
    cut = (layout.min_px + layout.max_px) / 2
    return ("interactive"
            if max(image.shape[0], image.shape[1]) <= cut else "batch")


# ---------------- replays ----------------


def drain_all(engine, images) -> tuple[float, list]:
    """All arrivals at t=0; wall seconds and responses of the drain."""
    for i, im in enumerate(images):
        engine.submit(im, request_id=i, arrival_s=0.0,
                      slo=slo_class(im, engine.layout))
    t0 = time.perf_counter()
    responses = []
    while engine.queue_len:
        responses.extend(engine.flush())
    wall = time.perf_counter() - t0
    assert len(responses) == len(images)
    return wall, responses


def _lat_summary(latencies_s: list) -> dict:
    """Exact nearest-rank percentiles of a latency sample."""
    from dinov3_tpu_torch.telemetry.hist import quantile_nearest_rank

    lats = sorted(latencies_s)
    return {
        "n": len(lats),
        "p50_ms": round(1e3 * quantile_nearest_rank(lats, 0.50), 3),
        "p99_ms": round(1e3 * quantile_nearest_rank(lats, 0.99), 3),
        "mean_ms": round(1e3 * sum(lats) / len(lats), 3),
    }


def rated_replay(engine, trace) -> dict:
    """Virtual-clock replay of a timed arrival trace ([(arrival_s,
    image)] sorted by arrival): the clock jumps to the next arrival or
    flush deadline while idle and advances by each flush's measured wall
    time while serving. With an observer attached, each latency also goes
    to its SLO class's streaming histogram."""
    now, i = 0.0, 0
    responses = []
    obs = getattr(engine, "observer", None)
    while i < len(trace) or engine.queue_len:
        while i < len(trace) and trace[i][0] <= now:
            engine.submit(trace[i][1], request_id=i, arrival_s=trace[i][0],
                          slo=slo_class(trace[i][1], engine.layout))
            i += 1
        if engine.should_flush(now) or (i >= len(trace) and engine.queue_len):
            t0 = time.perf_counter()
            out = engine.flush()
            now += time.perf_counter() - t0
            for r in out:
                r.done_s = now
                if obs is not None:
                    obs.observe_latency(r.slo, r.latency_s, r.request_id)
            responses.extend(out)
            continue
        nxt = []
        if i < len(trace):
            nxt.append(trace[i][0])
        deadline = engine.flush_deadline()
        if deadline is not None:
            nxt.append(deadline)
        if not nxt:
            break
        # always advance: a stalled clock here would spin forever
        target = max(now, min(nxt))
        now = target if target > now else now + 1e-6
    out = _lat_summary([r.latency_s for r in responses])
    by_slo: dict = {}
    for r in responses:
        by_slo.setdefault(r.slo, []).append(r.latency_s)
    out["by_slo"] = {slo: _lat_summary(v)
                     for slo, v in sorted(by_slo.items())}
    return out


# ---------------- record blocks ----------------


def _serve_summary(engine) -> dict:
    """An arm's "serve" block: arm, token-budget shape, measured pad
    waste (mean since the last ``reset_pad_stats``, and the last pack's),
    the compile count, the fetch-funnel counters since the last arm
    boundary (read and reset) and, with an observer, its finalized
    summary."""
    from dinov3_tpu_torch.telemetry.host_sync import host_sync_stats

    L = engine.layout
    mean_waste = engine.mean_pad_waste
    out = {
        "arm": engine.arm,
        "rows": L.rows,
        "row_tokens": L.row_tokens,
        "token_budget": L.token_budget,
        "pad_waste": (round(mean_waste, 4)
                      if mean_waste is not None else None),
        "pad_waste_last_pack": (round(engine.last_pad_waste, 4)
                                if engine.last_pad_waste is not None
                                else None),
        "compile_count": engine.compile_count,
        "host_sync": host_sync_stats(reset=True),
    }
    if engine.observer is not None:
        out["obs"] = engine.observer.finalize()
    return out


def _fleet_summary(router) -> dict:
    """The fleet block: per engine its arm, weights dtype, layout, SLO
    contract, fingerprint, byte accounting, compile count, packs and pad
    waste; the route counts, the cache counters and the total compile
    count."""
    from dinov3_tpu_torch.serve.quant import quant_summary

    engines = {}
    for spec in router.specs:
        e = spec.engine
        L = e.layout
        mean_waste = e.mean_pad_waste
        engines[spec.name] = {
            "arm": e.arm,
            "dtype": e.weights_dtype,
            "rows": L.rows,
            "row_tokens": L.row_tokens,
            "token_budget": L.token_budget,
            "max_segments_per_row": L.max_segments_per_row,
            "slo_classes": (None if spec.slo_classes is None
                            else list(spec.slo_classes)),
            "weights_fingerprint": spec.fingerprint,
            "quant": quant_summary(e.model),
            "compile_count": e.compile_count,
            "packs_run": e.packs_run,
            "pad_waste": (round(mean_waste, 4)
                          if mean_waste is not None else None),
        }
    return {
        "n_engines": len(router.specs),
        "engines": engines,
        "compile_count_total": router.compile_count,
        "route_counts": {f"{en}/{slo}": c for (en, slo), c
                         in sorted(router.route_counts.items())},
        "cache": (router.cache.stats()
                  if router.cache is not None else None),
    }


def _layout_record(layout) -> dict:
    return {
        "rows": layout.rows, "row_tokens": layout.row_tokens,
        "token_budget": layout.token_budget,
        "n_prefix": layout.n_prefix,
        "patch_size": layout.patch_size,
        "min_px": layout.min_px, "max_px": layout.max_px,
        "max_segments_per_row": layout.max_segments_per_row,
    }


# ---------------- per-arm measurement ----------------


def measure_arm(engine, warm_images, meas_images, trace,
                serve_summary, warn_fn, observer=None) -> tuple[dict, list]:
    """Disjoint warm-up draw, sustained drain, rated replay, summary. The
    observer attaches after the warm-up, beside the funnel reset, so its
    pack count covers exactly the measured window (fetches == packs)."""
    from dinov3_tpu_torch.telemetry.host_sync import host_sync_stats

    drain_all(engine, warm_images)
    compiles_after_warmup = engine.compile_count

    host_sync_stats(reset=True)
    engine.reset_pad_stats()
    engine.observer = observer
    wall, responses = drain_all(engine, meas_images)
    lat = rated_replay(engine, trace)
    warm_shapes = {im.shape for im in warm_images}
    rec = {
        "throughput": {
            "images_per_s": round(len(meas_images) / wall, 3),
            "wall_s": round(wall, 4),
        },
        "latency": lat,
        "compile_count_after_warmup": compiles_after_warmup,
        "compile_growth_during_measurement": (
            engine.compile_count - compiles_after_warmup),
        "novel_shapes_after_warmup": len(
            {im.shape for im in meas_images} - warm_shapes),
        "serve": serve_summary(engine),
        "pad_waste_warning": warn_fn(engine.mean_pad_waste or 0.0),
    }
    engine.observer = None
    return rec, responses


def feature_agreement(a, b) -> dict:
    """Max |diff| between two arms' responses, matched by request id."""
    bb = {r.request_id: r for r in b}
    cls = max(float(np.abs(r.cls_feature - bb[r.request_id].cls_feature).max())
              for r in a)
    pooled = max(float(np.abs(r.pooled_patch_feature
                              - bb[r.request_id].pooled_patch_feature).max())
                 for r in a)
    return {"cls_max_abs_diff": cls, "pooled_max_abs_diff": pooled}


# ---------------- the fleet ----------------


def repeat_trace(rng, fresh_images, n_req, hit_rate):
    """A request sequence with repeated content at about ``hit_rate``:
    each position repeats a uniformly chosen earlier position's image
    object with probability hit_rate, else takes the next fresh image. A
    repeat that lands while its original is still queued misses (and
    computes twice), so the measured rate trails the target."""
    seq = []
    fresh_i = 0
    for _ in range(int(n_req)):
        if seq and rng.random() < hit_rate:
            seq.append(seq[int(rng.integers(len(seq)))])
        else:
            seq.append(fresh_images[fresh_i % len(fresh_images)])
            fresh_i += 1
    return seq


def fleet_drain(router, images, layout) -> tuple[float, list]:
    """Sustained drain through the admission layer (all arrivals t=0)."""
    for i, im in enumerate(images):
        router.submit(im, request_id=i, arrival_s=0.0,
                      slo=slo_class(im, layout))
    t0 = time.perf_counter()
    responses = []
    while router.queue_len:
        responses.extend(router.flush())
    wall = time.perf_counter() - t0
    assert len(responses) == len(images)
    return wall, responses


def fleet_rated_replay(router, trace, layout) -> tuple[list, dict]:
    """``rated_replay`` through a ``FleetRouter``, auditing the cache as
    it goes: every hit is compared bitwise with the latest computed
    (miss) response for the same image. ``flush(now)`` flushes only the
    engines due mid-trace; the drain tail flushes all."""
    now, i = 0.0, 0
    responses: list = []
    obs = router.observer
    last_miss: dict = {}
    audit = {"hits": 0, "bitwise_failures": 0}
    while i < len(trace) or router.queue_len:
        while i < len(trace) and trace[i][0] <= now:
            router.submit(trace[i][1], request_id=i, arrival_s=trace[i][0],
                          slo=slo_class(trace[i][1], layout))
            i += 1
        if router.should_flush(now) or (i >= len(trace) and router.queue_len):
            t0 = time.perf_counter()
            out = router.flush(now if i < len(trace) else None)
            now += time.perf_counter() - t0
            for r in out:
                r.done_s = now
                img = trace[r.request_id][1]
                if r.cache_hit:
                    audit["hits"] += 1
                    ref = last_miss.get(id(img))
                    if ref is None or not (
                            np.array_equal(r.cls_feature, ref.cls_feature)
                            and np.array_equal(r.pooled_patch_feature,
                                               ref.pooled_patch_feature)):
                        audit["bitwise_failures"] += 1
                else:
                    last_miss[id(img)] = r
                if obs is not None:
                    obs.observe_latency(f"{r.engine}/{r.slo}",
                                        r.latency_s, r.request_id)
            responses.extend(out)
            continue
        nxt = []
        if i < len(trace):
            nxt.append(trace[i][0])
        deadline = router.flush_deadline()
        if deadline is not None:
            nxt.append(deadline)
        if not nxt:
            break
        target = max(now, min(nxt))
        now = target if target > now else now + 1e-6
    return responses, audit


def fleet_engines_from_envelope(env: dict) -> list:
    """The fleet's ``serve.fleet.engines`` overlays: an int8 fast lane
    for ``interactive`` traffic on the derived envelope, then the full
    bf16 row."""
    return [
        {"name": "fast_int8", "slo": "interactive", "quant": True,
         "rows": env["rows"], "row_tokens": env["row_tokens"],
         "max_segments_per_row": env["max_segments_per_row"],
         "min_px": env.get("min_px"), "max_px": env.get("max_px")},
        {"name": "full_bf16"},
    ]


def derive_fast_envelope(warm_images, layout) -> dict:
    """The interactive share of a warm draw through a ``LiveMixTracker``
    -> its recommended envelope."""
    from dinov3_tpu_torch.telemetry import LiveMixTracker

    tracker = LiveMixTracker(layout)
    for im in warm_images:
        if slo_class(im, layout) == "interactive":
            tracker.observe_request(
                layout.seq_len(im.shape[0], im.shape[1]),
                im.shape[0], im.shape[1])
    tracker.roll()
    env = tracker.recommended_serve_envelope(threshold=0.15)
    assert env is not None, "no interactive traffic in the warm draw"
    return env


def run_fleet(args, cfg, mixes, tracer) -> dict:
    """The fleet record: int8 A/B, the derived-envelope fleet, the cache
    hit-rate sweep."""
    from dinov3_tpu_torch.configs.config import (
        serve_obs_kwargs,
        warn_quant_drift,
    )
    from dinov3_tpu_torch.serve import (
        PackedServeEngine,
        build_serve_fleet,
        load_serving_model,
        quant_feature_drift,
        quant_summary,
        quantize_serving_model,
        serve_layout_from_cfg,
    )
    from dinov3_tpu_torch.telemetry import ServeObserver

    n = args.n or (12 if args.smoke else 64)
    qcfg = cfg.serve.get("quant") or {}
    tol = float(qcfg.get("drift_tol", 0.05) or 0.05)

    t0 = time.perf_counter()
    model = load_serving_model(cfg, device=args.device, seed=args.seed)
    layout = serve_layout_from_cfg(cfg)
    print(f"[bench_serve] fleet: {cfg.student.arch} base rows="
          f"{layout.rows}x{layout.row_tokens} envelope={layout.min_px}.."
          f"{layout.max_px}px build {time.perf_counter() - t0:.1f}s",
          flush=True)

    bands = mixes["mixed_ragged"]
    rng = np.random.default_rng(args.seed)
    warm_images = make_mix(rng, bands, n, layout.patch_size)
    meas_images = make_mix(rng, bands, n, layout.patch_size)

    # ---- int8: drift probe + single-engine A/B ----
    qmodel = quantize_serving_model(model)
    probe_px = int(qcfg.get("probe_px", 0) or 0)
    if probe_px <= 0:
        p = layout.patch_size
        probe_px = max(p, (min(layout.max_px, 224) // p) * p)
    drift = quant_feature_drift(model, qmodel, px=probe_px, seed=args.seed)
    drift_warning = warn_quant_drift(
        drift["cls_max_abs_diff"], tol=tol,
        axis=f"int8 serving model, {probe_px}px CLS probe")
    print(f"[bench_serve] quant drift: {drift} (tol {tol})", flush=True)

    eng = {"bf16": PackedServeEngine(model, layout, warn=False),
           "int8": PackedServeEngine(qmodel, layout, warn=False)}
    for e in eng.values():
        drain_all(e, warm_images)
    reps = 2 if args.smoke else 3
    best = {}
    ab_responses = {}
    for _ in range(reps):
        # alternate the arms within each rep; keep each one's best drain
        for name, e in eng.items():
            wall, rs = drain_all(e, meas_images)
            rate = len(meas_images) / wall
            if rate > best.get(name, 0.0):
                best[name] = rate
            ab_responses[name] = rs
    agreement = feature_agreement(ab_responses["bf16"], ab_responses["int8"])
    quant_rec = {
        "drift_probe": drift,
        "drift_tol": tol,
        "drift_warning": drift_warning,
        "summary": quant_summary(qmodel),
        "throughput": {
            "reps_best_of": reps,
            "bf16_images_per_s": round(best["bf16"], 3),
            "int8_images_per_s": round(best["int8"], 3),
            "int8_over_bf16": round(best["int8"] / best["bf16"], 4),
        },
        "packed_feature_agreement": agreement,
    }
    print(f"[bench_serve] quant A/B: bf16 {best['bf16']:.3f} img/s, "
          f"int8 {best['int8']:.3f} img/s "
          f"(x{best['int8'] / best['bf16']:.3f})", flush=True)
    del eng, qmodel

    # ---- the fleet: derived int8 fast lane + full bf16 row ----
    env = derive_fast_envelope(warm_images, layout)
    cfg.serve.fleet.engines = fleet_engines_from_envelope(env)
    router = build_serve_fleet(cfg, model.state_dict(), device=args.device,
                               warn=False)
    del model
    n_engines = len(router.specs)
    compiles_at_build = router.compile_count
    fleet_obs = ServeObserver(tracer, layout, slo_classes=(),
                              **serve_obs_kwargs(cfg))
    fleet_obs.set_labels(mix="fleet")
    router.observer = fleet_obs
    for spec in router.specs:
        o = ServeObserver(tracer, spec.engine.layout,
                          slo_classes=("interactive", "batch"),
                          **serve_obs_kwargs(cfg))
        o.set_labels(arm=spec.engine.arm, mix="fleet", engine=spec.name)
        spec.engine.observer = o
    print("[bench_serve] fleet engines: "
          + ", ".join(f"{s.name}({s.engine.arm} "
                      f"{s.engine.layout.rows}x{s.engine.layout.row_tokens})"
                      for s in router.specs)
          + f", {compiles_at_build} compiles", flush=True)

    # the cold-cache sustained rate sets the offered rate of every sweep
    wall, _ = fleet_drain(router, warm_images, layout)
    rate = 0.7 * (n / wall)

    sweeps = {}
    for hit_rate in (0.0, 0.5, 0.9):
        router.cache.clear(reset_counters=True)
        seq = repeat_trace(rng, meas_images, n, hit_rate)
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
        trace = [(float(a), im) for a, im in zip(arrivals, seq)]
        responses, audit = fleet_rated_replay(router, trace, layout)
        assert len(responses) == n
        by_key: dict = {}
        by_slo: dict = {}
        for r in responses:
            by_key.setdefault(f"{r.engine}/{r.slo}", []).append(r.latency_s)
            by_slo.setdefault(r.slo, []).append(r.latency_s)
        stats = router.cache.stats()
        sweeps[f"hit_{hit_rate}"] = {
            "target_hit_rate": hit_rate,
            "measured_hit_rate": stats["hit_rate"],
            "n_responses": len(responses),
            "cache": stats,
            "cache_hits_bitwise_equal": audit["bitwise_failures"] == 0,
            "cache_hit_responses": audit["hits"],
            "latency": _lat_summary([r.latency_s for r in responses]),
            "by_engine_slo": {k: _lat_summary(v)
                              for k, v in sorted(by_key.items())},
            "by_slo": {k: _lat_summary(v)
                       for k, v in sorted(by_slo.items())},
            "compile_count": router.compile_count,
            "compile_growth": router.compile_count - compiles_at_build,
        }
        print(f"[bench_serve] fleet hit={hit_rate}: measured "
              f"{stats['hit_rate']} p99 "
              f"{sweeps[f'hit_{hit_rate}']['latency']['p99_ms']}ms "
              f"routes {dict(router.route_counts)}", flush=True)

    # forced hit: the same image twice, back to back
    probe_img = meas_images[0]
    router.cache.clear(reset_counters=True)
    router.submit(probe_img, request_id=900001, arrival_s=0.0,
                  slo=slo_class(probe_img, layout))
    miss = []
    while router.queue_len:
        miss.extend(router.flush())
    router.submit(probe_img, request_id=900002, arrival_s=0.0,
                  slo=slo_class(probe_img, layout))
    hit = []
    while router.queue_len:
        hit.extend(router.flush())
    forced_ok = (len(miss) == 1 and len(hit) == 1 and hit[0].cache_hit
                 and not miss[0].cache_hit
                 and np.array_equal(miss[0].cls_feature, hit[0].cls_feature)
                 and np.array_equal(miss[0].pooled_patch_feature,
                                    hit[0].pooled_patch_feature))

    fleet_rec = {
        "derived_fast_envelope": env,
        "offered_rate_images_per_s": round(rate, 3),
        "sweeps": sweeps,
        "forced_hit_bitwise": bool(forced_ok),
        "drift_check": router.check_drift(warn=False),
        "summary": _fleet_summary(router),
        "observer": fleet_obs.finalize(),
    }
    router.finalize()

    return {
        "what": ("quantized multi-tenant serving fleet: int8-vs-bf16 "
                 "single-engine A/B (drift probe + best-of-k sustained "
                 "drains on the same mixed-ragged draw), then a 2-engine "
                 "fleet — an int8 fast lane whose envelope is derived "
                 "from the measured interactive mix next to the full "
                 "bf16 row — behind one SLO/shape admission layer with "
                 "the content-addressed feature cache in front, rated-"
                 "replayed at cache hit rates {0, 0.5, 0.9} with "
                 "per-(engine, SLO) p50/p99, every cache hit audited "
                 "bitwise against its miss, and total compiles pinned "
                 "at n_engines"),
        "arch": cfg.student.arch,
        "smoke": bool(args.smoke),
        "seed": args.seed,
        "n_per_sweep": n,
        "backend": args.device,
        "layout": _layout_record(layout),
        "quant": quant_rec,
        "fleet": fleet_rec,
        "n_engines": n_engines,
        "compile_count_total": router.compile_count,
        "compile_growth_total": router.compile_count - compiles_at_build,
    }


# ---------------- the arms record ----------------


def run_arms(args, cfg, mixes, tracer) -> dict:
    """The arms record: three mixes x (packed, oracle_rectangular,
    oracle_per_image)."""
    from dinov3_tpu_torch.configs.config import (
        serve_obs_kwargs,
        serve_pad_waste_floor,
        warn_serve_pad_waste,
    )
    from dinov3_tpu_torch.serve import (
        OracleServeEngine,
        PackedServeEngine,
        load_serving_model,
        serve_layout_from_cfg,
    )
    from dinov3_tpu_torch.telemetry import ServeObserver

    n = args.n or (12 if args.smoke else 64)
    t0 = time.perf_counter()
    model = load_serving_model(cfg, device=args.device, seed=args.seed)
    layout = serve_layout_from_cfg(cfg)
    floor = serve_pad_waste_floor(
        layout.row_tokens, layout.patch_size, layout.n_prefix,
        layout.min_px, layout.max_px)
    print(f"[bench_serve] {cfg.student.arch} rows={layout.rows} "
          f"row_tokens={layout.row_tokens} budget={layout.token_budget} "
          f"envelope={layout.min_px}..{layout.max_px}px "
          f"floor(mean)={floor['mean_waste']:.3f} "
          f"build {time.perf_counter() - t0:.1f}s", flush=True)

    def build_engine(arm):
        if arm == "packed":
            return PackedServeEngine(model, layout, warn=False)
        return OracleServeEngine(model, layout,
                                 mode=arm.removeprefix("oracle_"))

    record = {
        "what": ("continuous-packing serve engine vs naive oracles: "
                 "sustained img/s + rated p50/p99 over three traffic "
                 "mixes, identical bf16 weights and batcher policy; "
                 "oracle arms warm on a disjoint draw, so their "
                 "recompiles on novel traffic shapes are measured "
                 "serving cost"),
        "arch": cfg.student.arch,
        "smoke": bool(args.smoke),
        "seed": args.seed,
        "n_per_mix": n,
        "backend": args.device,
        "layout": _layout_record(layout),
        "pad_waste_floor": {k: round(v, 4) if isinstance(v, float) else v
                            for k, v in floor.items()},
        "mixes": {},
    }

    arms = ("packed", "oracle_rectangular", "oracle_per_image")
    engines = {arm: build_engine(arm) for arm in arms}
    for mix_name, bands in mixes.items():
        rng = np.random.default_rng(args.seed)
        warm_images = make_mix(rng, bands, n, layout.patch_size)
        meas_images = make_mix(rng, bands, n, layout.patch_size)
        mix_rec = {
            "n": n,
            "measured_tokens": sum(layout.seq_len(im.shape[0], im.shape[1])
                                   for im in meas_images),
            "distinct_shapes_measured": len({im.shape for im in meas_images}),
        }
        responses = {}
        # packed first: its sustained rate sets the rated replay's
        # arrival trace, which every arm then replays
        trace = None
        for arm in arms:
            eng = engines[arm]
            print(f"[bench_serve] {mix_name}/{arm} ...", flush=True)
            if trace is None:
                drain_all(eng, warm_images)
                wall, _ = drain_all(eng, warm_images)
                rate = 0.7 * (n / wall)
                arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
                trace = [(float(a), im)
                         for a, im in zip(arrivals, meas_images)]
                mix_rec["offered_rate_images_per_s"] = round(rate, 3)
            observer = ServeObserver(tracer, layout,
                                     slo_classes=("interactive", "batch"),
                                     **serve_obs_kwargs(cfg))
            observer.set_labels(arm=arm, mix=mix_name)
            arm_rec, resp = measure_arm(
                eng, warm_images, meas_images, trace, _serve_summary,
                lambda w, a=arm: warn_serve_pad_waste(
                    w, stacklevel=3,
                    axis=f"measured {mix_name} mix, {a} arm"),
                observer=observer)
            mix_rec[arm] = arm_rec
            responses[arm] = resp
        for arm in ("oracle_rectangular", "oracle_per_image"):
            mix_rec[f"features_vs_{arm}"] = feature_agreement(
                responses["packed"], responses[arm])
        packed_rate = mix_rec["packed"]["throughput"]["images_per_s"]
        mix_rec["speedup_vs_rectangular"] = round(
            packed_rate
            / mix_rec["oracle_rectangular"]["throughput"]["images_per_s"], 3)
        mix_rec["speedup_vs_per_image"] = round(
            packed_rate
            / mix_rec["oracle_per_image"]["throughput"]["images_per_s"], 3)
        record["mixes"][mix_name] = mix_rec
        print(f"[bench_serve] {mix_name}: packed {packed_rate} img/s, "
              f"rect x{mix_rec['speedup_vs_rectangular']}, "
              f"per-image x{mix_rec['speedup_vs_per_image']}", flush=True)
    record["packed_compile_count"] = engines["packed"].compile_count
    return record


# ---------------- main ----------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dinov3_tpu_torch.serve.bench",
        description="The serving bench: packed engine vs oracles, or "
                    "(--fleet) int8 + fleet + cache.")
    ap.add_argument("--smoke", action="store_true",
                    help="ViT-S/4 at 8..32 px: a run of seconds")
    ap.add_argument("--fleet", action="store_true",
                    help="the int8 A/B, the 2-engine fleet and the cache "
                         "hit-rate sweep")
    ap.add_argument("--out", default=None,
                    help="the record (default serve_bench[_fleet].json in "
                         "the working directory)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=None,
                    help="images per mix (default: 64 full / 12 smoke)")
    ap.add_argument("--obs-dir", default=None,
                    help="output dir of the serve span stream (default: a "
                         "temporary dir)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("overrides", nargs="*", metavar="key=value",
                    help="config overrides applied after the run's own "
                         "(e.g. student.arch=vit_test)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = "serve_bench_fleet.json" if args.fleet else "serve_bench.json"

    from dinov3_tpu_torch.configs.config import (
        apply_dot_overrides,
        get_default_config,
    )
    from dinov3_tpu_torch.ops.common import resolve_device
    from dinov3_tpu_torch.telemetry import SPAN_SCHEMA_V, SpanTracer

    resolve_device(args.device)
    cfg = get_default_config()
    apply_dot_overrides(cfg, (SMOKE_OVERRIDES if args.smoke else FULL_OVERRIDES)
                        + list(args.overrides))
    mixes = MIXES_SMOKE if args.smoke else MIXES_FULL

    obs_dir = args.obs_dir or tempfile.mkdtemp(prefix="bench_serve_obs_")
    # one serve-role tracer for the whole run: every (mix, arm) observer
    # writes into the same labelled spans.serve.jsonl stream
    tracer = SpanTracer(obs_dir, role="serve")
    print(f"[bench_serve] serve span stream: {tracer.spans_path}", flush=True)
    if args.fleet:
        record = run_fleet(args, cfg, mixes, tracer)
        tracer.close()
    else:
        record = run_arms(args, cfg, mixes, tracer)
        tracer.close()
        record["obs"] = {"spans_path": os.path.abspath(tracer.spans_path),
                         "schema_v": SPAN_SCHEMA_V}
    out = json.dumps(record, indent=1, sort_keys=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
