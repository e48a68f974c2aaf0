"""Step-anatomy ledger (``dinov3_tpu/telemetry/anatomy.py``): measured
device-time attribution for one ``torch.profiler`` window, plus the fleet
report over the span JSONL streams.

``anatomy_ledger`` turns a trace (``telemetry/trace.py``) into per-step
rows with the reference's keys and schema:

- device time split into ``CATEGORIES`` by kernel name (``categorize``);
- collective time with its measured overlap: each collective interval is
  intersected with the union of the other device work on its timeline;
- the backward interval of each step;
- and, the port's addition, ``scopes``: device ms per named scope.

Joins without HLO. The reference joins trace events to the compiled
HLO's ``op_name`` metadata (``build_op_index``); PyTorch has no HLO, so
``build_op_index`` is not ported (by design). Instead each device event
is joined, through Kineto's ``correlation`` id, to the runtime call that
launched it (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``), and that call's host timestamp to:

- the step: the ``record_function`` annotation ``train_step#N`` (the
  trainer's) or ``ProfilerStep#N`` (``prof.step()``) whose interval holds
  the launch, on any thread of its process (the backward runs on the
  autograd engine's thread while the loop's thread waits inside the
  step). With no step annotation in the trace, the reference's
  ``step_windows`` cuts each timeline at its largest idle gaps;
- the scope: the innermost other ``record_function`` on the launching
  thread that holds the launch (``telemetry_ring``, ``lowp_amax``,
  ``lowp_dequant``, ``crop_pack``);
- the backward: a launch inside an ``autograd::engine::evaluate_function``
  CPU op (the reference reads jax's ``transpose(...)`` stamp).

``categorize`` keeps the reference's answers on XLA's names and adds the
CUDA kernel names, checked first:

- ``nccl`` -> ``collective``;
- the port's kernels by name: ``flash_*`` (K1-K3 and K1's tile
  schedule) -> ``softmax/exp``; ``layernorm*`` (K4, K5) -> ``norm/reduce``;
- GEMMs (``gemm``, ``xmma``, ``cutlass``, ``nvjet``, the ``_scaled_mm`` /
  ``int_mm`` kernels) -> ``matmul/conv``;
- ``Memcpy`` / ``Memset`` -> ``copy/layout``;
- ``reduce_kernel`` -> ``norm/reduce``;
- ``elementwise`` (``vectorized_elementwise``, ``unrolled_elementwise``,
  ``elementwise_kernel``) -> ``fusion/elementwise``.

A trace whose device timeline is empty (the profiler recorded no CUDA
activity) raises: the ledger is never made from host events alone.
Not ported yet: ``tuning_summary`` waits with ``tuning/`` (ROADMAP M12).
"""

from __future__ import annotations

import bisect
import glob
import json
import math
import os
import re
import time

from dinov3_tpu_torch.telemetry.trace import Trace, find_trace_file, load_trace

SCHEMA = "anatomy/v1"
SUMMARY_SCHEMA = "anatomy-summary/v1"

CATEGORIES = (
    "matmul/conv", "collective", "softmax/exp", "norm/reduce",
    "copy/layout", "fusion/elementwise", "other",
)

_MATMUL_TOKENS = frozenset(
    ("dot", "conv", "convolution", "einsum", "gemm", "matmul", "cudnn"))
_COPY_TOKENS = frozenset((
    "copy", "transpose", "reshape", "bitcast", "slice", "concatenate",
    "pad", "gather", "scatter", "convert", "dynamic",
))
_COLLECTIVE_KEYS = (
    "all-reduce", "all-gather", "reduce-scatter", "collective",
    "all-to-all", "psum", "permute",
)
_TOKEN_SPLIT = re.compile(r"[^a-z0-9]+")
# CUDA kernel names, checked before the reference's XLA vocabulary
_CUDA_RULES = (
    (("nccl",), "collective"),
    (("flash_",), "softmax/exp"),
    (("layernorm",), "norm/reduce"),
    (("gemm", "xmma", "cutlass", "nvjet", "scaled_mm", "int_mm"), "matmul/conv"),
    (("memcpy", "memset"), "copy/layout"),
    (("reduce_kernel",), "norm/reduce"),
    (("elementwise",), "fusion/elementwise"),
)
# the per-iteration annotations that cut steps
STEP_ANNOTATION = re.compile(r"^(?:train_step|ProfilerStep)#(\d+)$")
_BACKWARD_OP = "autograd::engine::evaluate_function"


def categorize(name: str, fusion_dotty: bool | None = None) -> str:
    """Device-op category from a CUDA kernel name (the rules in the module
    docstring) or an XLA instruction name (the reference's rules)."""
    n = name.lower()
    for tokens, cat in _CUDA_RULES:
        if any(t in n for t in tokens):
            return cat
    for key in _COLLECTIVE_KEYS:
        if key in n:
            return "collective"
    parts = [p for p in _TOKEN_SPLIT.split(n) if p]
    if fusion_dotty or any(p in _MATMUL_TOKENS for p in parts):
        return "matmul/conv"
    if "softmax" in n or "exponential" in parts or "exp" in parts:
        return "softmax/exp"
    if "norm" in n or "rsqrt" in parts or "reduce" in parts \
            or "reduction" in parts:
        return "norm/reduce"
    if any(p in _COPY_TOKENS for p in parts):
        return "copy/layout"
    if "fusion" in parts:
        return "fusion/elementwise"
    return "other"


# ---------------------------------------------------------------------
# interval arithmetic (times in us)
# ---------------------------------------------------------------------

def merge_intervals(intervals: list) -> list:
    """Sorted union of half-open ``(start, end)`` intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect_length(start: float, end: float, merged: list) -> float:
    """Length of ``[start, end)`` covered by a ``merge_intervals`` union."""
    if end <= start or not merged:
        return 0.0
    starts = [s for s, _ in merged]
    i = max(0, bisect.bisect_right(starts, start) - 1)
    total = 0.0
    while i < len(merged):
        s, e = merged[i]
        if s >= end:
            break
        lo, hi = max(s, start), min(e, end)
        if hi > lo:
            total += hi - lo
        i += 1
    return total


def step_windows(events: list, n_steps: int | None = None) -> list:
    """Split one timeline's events into ``n_steps`` windows at its
    ``n_steps - 1`` largest idle gaps (the reference's rule; the ledger
    uses it only when the trace has no step annotation). One window when
    ``n_steps`` is absent or the timeline is too sparse to split."""
    if not events:
        return []
    evs = sorted(events, key=lambda e: e.ts)
    t_end = max(e.end for e in evs)
    if not n_steps or n_steps <= 1 or len(evs) < n_steps:
        return [(evs[0].ts, t_end)]
    gaps = []
    run_end = evs[0].end
    for i in range(1, len(evs)):
        gaps.append((evs[i].ts - run_end, i))
        run_end = max(run_end, evs[i].end)
    cuts = sorted(i for _, i in
                  sorted(gaps, key=lambda g: -g[0])[: n_steps - 1])
    bounds = [evs[0].ts] + [evs[i].ts for i in cuts] + [t_end + 1e-9]
    return [(bounds[k], bounds[k + 1]) for k in range(len(bounds) - 1)]


def _innermost(intervals: list, points: list) -> dict:
    """For sorted ``intervals`` [(start, end, name)] of one thread (outer
    before inner at equal starts) and ``points`` [(t, key)]: {key: the
    name of the innermost interval holding t}, by one sweep."""
    out: dict = {}
    stack: list = []
    j = 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while j < len(intervals) and intervals[j][0] <= t:
            iv = intervals[j]
            while stack and stack[-1][1] <= iv[0]:
                stack.pop()
            stack.append(iv)
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def _launch_attribution(trace: Trace, events: list) -> dict:
    """{id(event): (step or None, scope or None, backward)} through each
    device event's launching runtime call (module docstring)."""
    launches = trace.launches()
    user = trace.host_intervals(lambda e: e.cat == "user_annotation")
    steps_by_pid: dict = {}
    scopes: dict = {}
    for key, ivs in user.items():
        plain = []
        for s, e, name in ivs:
            m = STEP_ANNOTATION.match(name)
            if m:
                steps_by_pid.setdefault(key[0], []).append((s, e, int(m.group(1))))
            else:
                plain.append((s, e, name))
        scopes[key] = plain
    step_starts = {}
    for pid, ivs in steps_by_pid.items():
        ivs.sort()
        step_starts[pid] = [s for s, _, _ in ivs]
    bwd = trace.host_intervals(
        lambda e: e.cat == "cpu_op" and e.name.startswith(_BACKWARD_OP))
    points: dict = {}
    out: dict = {}
    for e in events:
        ln = launches.get(e.correlation)
        if ln is None:
            out[id(e)] = (None, None, False)
            continue
        step = None
        ivs = steps_by_pid.get(ln.pid, [])
        k = bisect.bisect_right(step_starts.get(ln.pid, []), ln.ts) - 1
        if k >= 0 and ivs[k][0] <= ln.ts < ivs[k][1]:
            step = ivs[k][2]
        out[id(e)] = (step, None, False)
        points.setdefault((ln.pid, ln.tid), []).append((ln.ts, id(e)))
    for key, pts in points.items():
        sc = _innermost(scopes.get(key, []), pts)
        bw = _innermost(bwd.get(key, []), pts)
        for _, eid in pts:
            step = out[eid][0]
            out[eid] = (step, sc.get(eid), eid in bw)
    return out


def events_by_step(trace: Trace) -> dict:
    """{iteration: the device events launched inside that iteration's step
    annotation}, by the join ``anatomy_ledger`` makes."""
    events = trace.op_events()
    attr = _launch_attribution(trace, events)
    out: dict = {}
    for e in events:
        it = attr[id(e)][0]
        if it is not None:
            out.setdefault(it, []).append(e)
    return out


# ---------------------------------------------------------------------
# the anatomy ledger
# ---------------------------------------------------------------------

def _step_row(k: int, groups: list, attr: dict) -> dict:
    """One step's row from its events, grouped by timeline."""
    acc_cat = {c: 0.0 for c in CATEGORIES}
    coll: dict = {}
    scopes: dict = {}
    busy = backward_ms = 0.0
    t0, t1 = math.inf, -math.inf
    tl_busy: list = []
    for wevs in groups:
        if not wevs:
            continue
        t0 = min(t0, min(e.ts for e in wevs))
        t1 = max(t1, max(e.end for e in wevs))
        cats = [categorize(e.name) for e in wevs]
        compute_union = merge_intervals(
            [(e.ts, e.end) for e, c in zip(wevs, cats) if c != "collective"])
        bwd = [(e.ts, e.end) for e in wevs if attr[id(e)][2]]
        bwd_iv = (min(s for s, _ in bwd), max(e for _, e in bwd)) if bwd else None
        if bwd_iv:
            backward_ms += (bwd_iv[1] - bwd_iv[0]) / 1e3
        tb = 0.0
        for e, cat in zip(wevs, cats):
            acc_cat[cat] += e.dur / 1e3
            tb += e.dur / 1e3
            scope = attr[id(e)][1]
            if scope is not None:
                scopes[scope] = scopes.get(scope, 0.0) + e.dur / 1e3
            if cat != "collective":
                continue
            ent = coll.setdefault(scope or "unscoped", {
                "ms": 0.0, "exposed_ms": 0.0, "overlapped_ms": 0.0,
                "inside_backward_ms": 0.0, "n_events": 0,
            })
            ov = intersect_length(e.ts, e.end, compute_union)
            ent["ms"] += e.dur / 1e3
            ent["overlapped_ms"] += ov / 1e3
            ent["exposed_ms"] += (e.dur - ov) / 1e3
            ent["n_events"] += 1
            if bwd_iv:
                lo, hi = max(e.ts, bwd_iv[0]), min(e.end, bwd_iv[1])
                if hi > lo:
                    ent["inside_backward_ms"] += (hi - lo) / 1e3
        busy += tb
        tl_busy.append(tb)
    for ent in coll.values():
        ent["overlap_frac"] = ent["overlapped_ms"] / ent["ms"] if ent["ms"] else 0.0
        ent["inside_backward_frac"] = (
            ent["inside_backward_ms"] / ent["ms"] if ent["ms"] else 0.0)
    exposed_total = sum(c["exposed_ms"] for c in coll.values())
    spread = 0.0
    if tl_busy and max(tl_busy) > 0:
        mean_b = sum(tl_busy) / len(tl_busy)
        spread = (max(tl_busy) - min(tl_busy)) / mean_b if mean_b else 0.0
    return {
        "step": k,
        "wall_ms": (t1 - t0) / 1e3 if t1 > t0 else 0.0,
        "device_busy_ms": busy,
        "device_ms": {c: v for c, v in acc_cat.items() if v > 0},
        "collectives": coll,
        "exposed_comm_frac": exposed_total / busy if busy else 0.0,
        "backward_ms": backward_ms,
        "device_step_spread": spread,
        "scopes": scopes,
    }


def anatomy_ledger(trace: Trace | str, n_steps: int | None = None) -> dict:
    """Per-step anatomy ledger for one trace window (a ``Trace``, or a
    path / directory resolved through ``find_trace_file``). Steps come
    from the step annotations (their iteration is the row's ``iteration``)
    or, without any, from ``n_steps`` gap windows per timeline. Raises
    ``RuntimeError`` when the trace holds no device event. The reference's
    ``module`` and ``hlo_joined`` keys stay, None and False: there is no
    HLO module to join."""
    if isinstance(trace, str):
        path = find_trace_file(trace)
        if path is None:
            raise FileNotFoundError(f"no *.trace.json.gz under {trace!r}")
        trace = load_trace(path)
    events = trace.op_events()
    if not events:
        raise RuntimeError(
            f"trace {trace.path!r} holds no device event (kernel, memcpy, "
            "memset): the profiler recorded no CUDA activity")
    attr = _launch_attribution(trace, events)
    timelines = trace.timelines(events)
    iterations = sorted({a[0] for a in attr.values() if a[0] is not None})
    steps: list = []
    unwindowed = 0.0
    if iterations:
        for k, it in enumerate(iterations):
            groups = [[e for e in evs if attr[id(e)][0] == it]
                      for evs in timelines.values()]
            steps.append({**_step_row(k, groups, attr), "iteration": it})
        unwindowed = sum(e.dur for e in events if attr[id(e)][0] is None) / 1e3
    else:
        wins = {key: step_windows(evs, n_steps) for key, evs in timelines.items()}
        n_windows = max((len(w) for w in wins.values()), default=0)
        for k in range(n_windows):
            groups = []
            for key, evs in timelines.items():
                if k < len(wins[key]):
                    w0, w1 = wins[key][k]
                    groups.append([e for e in evs if w0 <= e.ts < w1])
            steps.append(_step_row(k, groups, attr))
    unattributed_ms = sum(
        s["collectives"].get("unattributed", {}).get("ms", 0.0) for s in steps)
    return {
        "schema": SCHEMA,
        "trace_path": trace.path,
        "module": None,
        "hlo_joined": False,
        "n_steps": len(steps),
        "n_timelines": len(timelines),
        "timelines": sorted(timelines),
        "steps": steps,
        "unattributed_collective_ms": unattributed_ms,
        "unwindowed_ms": unwindowed,
    }


def ledger_summary(ledger: dict) -> dict:
    """Flat per-step summary of one ledger (the ``anatomy`` span record)."""
    steps = ledger["steps"]
    n = max(1, len(steps))
    walls = [s["wall_ms"] for s in steps]
    mean_wall = sum(walls) / n
    var = sum((w - mean_wall) ** 2 for w in walls) / n if steps else 0.0
    cats: dict = {}
    coll: dict = {}
    busy = 0.0
    for s in steps:
        busy += s["device_busy_ms"]
        for c, v in s["device_ms"].items():
            cats[c] = cats.get(c, 0.0) + v
        for scope, ent in s["collectives"].items():
            agg = coll.setdefault(scope, {
                "ms": 0.0, "exposed_ms": 0.0, "overlapped_ms": 0.0,
                "inside_backward_ms": 0.0, "n_events": 0})
            for key in agg:
                agg[key] += ent[key]
    out_coll = {}
    for scope, agg in coll.items():
        out_coll[scope] = {
            "ms_per_step": agg["ms"] / n,
            "exposed_ms_per_step": agg["exposed_ms"] / n,
            "overlap_frac": agg["overlapped_ms"] / agg["ms"] if agg["ms"] else 0.0,
            "inside_backward_frac": agg["inside_backward_ms"] / agg["ms"]
            if agg["ms"] else 0.0,
            "n_events": agg["n_events"],
        }
    exposed = sum(a["exposed_ms"] for a in coll.values())
    spreads = [s["device_step_spread"] for s in steps]
    return {
        "schema": SUMMARY_SCHEMA,
        "module": ledger["module"],
        "n_steps": ledger["n_steps"],
        "n_timelines": ledger["n_timelines"],
        "hlo_joined": ledger["hlo_joined"],
        "step_wall_ms": {
            "mean": mean_wall, "std": math.sqrt(var),
            "min": min(walls) if walls else 0.0,
            "max": max(walls) if walls else 0.0,
        },
        "device_ms_per_step": {c: v / n for c, v in cats.items()},
        "device_busy_ms_per_step": busy / n,
        "collectives": out_coll,
        "exposed_comm_ms_per_step": exposed / n,
        "exposed_comm_frac": exposed / busy if busy else 0.0,
        "straggler_spread": sum(spreads) / n if steps else 0.0,
        "unattributed_collective_ms": ledger["unattributed_collective_ms"],
    }


# ---------------------------------------------------------------------
# fleet report over the span JSONL streams
# ---------------------------------------------------------------------

def load_span_streams(path: str, role: str = "train") -> dict:
    """``telemetry/spans*.jsonl`` under ``path`` (an output dir or its
    ``telemetry/``) -> ``{host_id: [records]}``, schema-v1 records of
    ``role`` only; host ids from the ``spans[.<role>][.rankN].jsonl``
    naming."""
    tdir = path
    if os.path.isdir(os.path.join(path, "telemetry")):
        tdir = os.path.join(path, "telemetry")
    streams: dict = {}
    for f in sorted(glob.glob(os.path.join(tdir, "spans*.jsonl"))):
        stem = os.path.basename(f)[: -len(".jsonl")]
        parts = stem.split(".")[1:]
        rank = next((p for p in parts if p.startswith("rank")), "rank0")
        recs = []
        with open(f) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue  # the torn tail line of a live writer
                if r.get("v") != 1:
                    continue
                if role and r.get("role", "train") != role:
                    continue
                recs.append(r)
        if recs:
            streams[rank] = streams.get(rank, []) + recs
    return streams


def _dist(xs: list) -> dict:
    n = len(xs)
    if not n:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "std": 0.0}
    ss = sorted(xs)
    mean = sum(xs) / n
    var = sum((x - mean) ** 2 for x in xs) / n
    return {
        "n": n, "mean": mean,
        "p50": ss[min(n - 1, int(0.50 * n))],
        "p95": ss[min(n - 1, int(0.95 * n))],
        "std": math.sqrt(var),
    }


def fleet_report(streams: dict | str, anatomy: dict | None = None,
                 input_bound_frac: float = 0.25, exposed_comm_tol: float = 0.25,
                 straggler_z: float = 2.0) -> dict:
    """Per-host step-time distributions (consecutive ``dispatch`` span
    starts), data-wait fractions, straggler z-scores and the verdict:
    input-bound when data wait takes more than ``input_bound_frac`` of the
    step, else comm-bound when ``anatomy``'s exposed-collective fraction
    passes ``exposed_comm_tol``, else compute-bound."""
    if isinstance(streams, str):
        streams = load_span_streams(streams)
    hosts: dict = {}
    for host, recs in sorted(streams.items()):
        per_phase: dict = {}
        dispatch: list = []
        for r in recs:
            name = r.get("name")
            if name == "dispatch" and r.get("iteration") is not None:
                dispatch.append((int(r["iteration"]), float(r.get("t", 0))))
            if "dur_ms" in r and name:
                per_phase.setdefault(name, []).append(float(r["dur_ms"]))
        dispatch.sort()
        step_ms = [
            (t1 - t0) * 1e3
            for (i0, t0), (i1, t1) in zip(dispatch, dispatch[1:])
            if i1 == i0 + 1 and t1 > t0
        ]
        if not step_ms:
            n = min((len(per_phase.get(p, [])) for p in ("dispatch",)), default=0)
            step_ms = [
                sum(per_phase.get(p, [0.0] * n)[i]
                    for p in ("data_wait", "h2d", "dispatch")
                    if i < len(per_phase.get(p, [])))
                for i in range(n)
            ]
        dist = _dist(step_ms)
        data_wait = per_phase.get("data_wait", [])
        dw_mean = sum(data_wait) / len(data_wait) if data_wait else 0.0
        hosts[host] = {
            "step_ms": dist,
            "data_wait_ms_mean": dw_mean,
            "data_wait_frac": dw_mean / dist["mean"] if dist["mean"] else 0.0,
            "n_spans": len(recs),
        }
    means = [h["step_ms"]["mean"] for h in hosts.values() if h["step_ms"]["n"]]
    fleet_mean = sum(means) / len(means) if means else 0.0
    fleet_var = (sum((m - fleet_mean) ** 2 for m in means) / len(means)
                 if means else 0.0)
    fleet_std = math.sqrt(fleet_var)
    stragglers = []
    for host, h in hosts.items():
        z = ((h["step_ms"]["mean"] - fleet_mean) / fleet_std
             if fleet_std > 0 and len(means) > 1 else 0.0)
        h["straggler_z"] = z
        if z > straggler_z:
            stragglers.append(host)
    dw_fracs = [h["data_wait_frac"] for h in hosts.values()]
    dw_frac = max(dw_fracs) if dw_fracs else 0.0
    exposed = (anatomy or {}).get("exposed_comm_frac")
    if dw_frac > input_bound_frac:
        verdict = "input-bound"
    elif exposed is not None and exposed > exposed_comm_tol:
        verdict = "comm-bound"
    else:
        verdict = "compute-bound"
    return {
        "schema": "fleet/v1",
        "n_hosts": len(hosts),
        "hosts": hosts,
        "fleet_step_ms": {"mean": fleet_mean, "std": fleet_std},
        "stragglers": stragglers,
        "max_data_wait_frac": dw_frac,
        "exposed_comm_frac": exposed,
        "verdict": verdict,
    }


# ---------------------------------------------------------------------
# train-loop wiring (--profile-steps)
# ---------------------------------------------------------------------

def round_floats(obj, ndigits: int = 4):
    """Round every float in a JSON-shaped structure."""
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: round_floats(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [round_floats(v, ndigits) for v in obj]
    return obj


def emit_step_anatomy(trace_dir: str, n_steps: int | None = None, tracer=None,
                      cfg=None, iteration: int | None = None,
                      out_path: str | None = None) -> dict | None:
    """Fold a just-stopped profiler window into the telemetry stream: the
    newest trace under ``trace_dir`` -> ledger, written whole as
    ``anatomy.json`` beside it; its summary emitted as an ``anatomy`` span
    record through ``tracer``, with the ``warn_exposed_comm`` guardrail
    against ``cfg``. Returns the summary (None when no trace file is
    found); a trace with no device event raises (``anatomy_ledger``)."""
    path = find_trace_file(trace_dir)
    if path is None:
        return None
    ledger = anatomy_ledger(load_trace(path), n_steps=n_steps)
    summary = ledger_summary(ledger)
    out_path = out_path or os.path.join(trace_dir, "anatomy.json")
    with open(out_path, "w") as f:
        json.dump(round_floats(ledger), f, indent=1)
    warn = None
    if cfg is not None:
        from dinov3_tpu_torch.configs.config import warn_exposed_comm

        warn = warn_exposed_comm(cfg, summary)
    if tracer is not None:
        tracer.emit({
            "name": "anatomy",
            "iteration": None if iteration is None else int(iteration),
            "t": round(time.time(), 6),
            "summary": round_floats(summary),
            "ledger_path": out_path,
            **({"warn": warn} if warn else {}),
        })
    return summary
