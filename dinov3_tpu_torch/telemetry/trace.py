"""``torch.profiler`` trace reader (``dinov3_tpu/telemetry/trace.py``):
a Kineto chrome trace -> normalized event timelines.

``torch.profiler.profile(...).export_chrome_trace(path)`` writes Kineto's
JSON; the trainer's ``--profile-steps`` window gzips it as
``<output-dir>/trace/<name>.trace.json.gz``, so ``find_trace_file``
finds it as it finds the JAX profiler's file.

- ``find_trace_file(root)``: the newest ``*.trace.json.gz`` under a
  trace directory (or ``root`` itself when it is a file).
- ``load_trace(path)`` -> ``Trace``: every complete (``ph == "X"``) event
  with its category, Kineto's ``args.correlation`` (kernel <-> the
  runtime call that launched it) and ``args["External id"]`` (runtime
  call <-> the CPU op that made it), and the process and thread names.
- ``Trace.op_events()``: the device events, those with ``cat``
  ``kernel``, ``gpu_memcpy`` or ``gpu_memset``. They live on the GPU's
  pid: each device pid is one timeline (``Trace.timelines``) and its
  tids are its streams, as in the JAX reader.
- ``Trace.launches()``: the CUDA runtime events (``cudaLaunchKernel``,
  ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...) by correlation id;
  ``Trace.host_intervals(pred)`` the CPU-side annotations and ops per
  (pid, tid), so ``anatomy.py`` can join a kernel to the
  ``record_function`` and the autograd op that launched it.

Times are microseconds (chrome trace format); the anatomy converts to ms
at its reporting boundary only.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os

# Kineto's device-side categories: each event of one runs on the card
DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
# pids whose process_name carries one of these are device timelines
_DEVICE_PID_MARKERS = ("/device:", "TPU", "GPU")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One complete (``ph == "X"``) trace event, times in microseconds.
    ``correlation`` and ``external_id`` are Kineto's join keys (None where
    the event has none)."""

    name: str
    pid: int
    tid: int
    ts: float
    dur: float
    cat: str = ""
    correlation: int | None = None
    external_id: int | None = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Trace:
    """All complete events of one trace window, plus name metadata."""

    events: list
    process_names: dict  # pid -> name
    thread_names: dict   # (pid, tid) -> name
    path: str = ""

    def op_events(self) -> list:
        """The device events: kernels, memcpys and memsets."""
        return [e for e in self.events if e.cat in DEVICE_CATS]

    def launches(self) -> dict:
        """correlation id -> the host event that launched the device work
        (Kineto's ``cuda_runtime`` / ``cuda_driver`` events)."""
        return {e.correlation: e for e in self.events
                if e.cat in ("cuda_runtime", "cuda_driver")
                and e.correlation is not None}

    def host_intervals(self, pred) -> dict:
        """(pid, tid) -> [(ts, end, name)] of the host events ``pred``
        accepts, sorted by start (outer before inner at equal starts)."""
        out: dict = {}
        for e in self.events:
            if e.cat not in DEVICE_CATS and pred(e):
                out.setdefault((e.pid, e.tid), []).append((e.ts, e.end, e.name))
        for ivs in out.values():
            ivs.sort(key=lambda iv: (iv[0], -iv[1]))
        return out

    def timelines(self, events: list) -> dict:
        """Group device events into per-device timelines: one per device
        pid, its tids being its streams. The key is the pid's process name
        where that names a device (``GPU 0``); Kineto may name the GPU's pid
        after the host process, and then the key is ``gpu:<pid>``."""
        out: dict = {}
        for e in events:
            name = str(self.process_names.get(e.pid) or "")
            key = name if any(m in name for m in _DEVICE_PID_MARKERS) else f"gpu:{e.pid}"
            out.setdefault(key, []).append(e)
        for evs in out.values():
            evs.sort(key=lambda e: e.ts)
        return out


def find_trace_file(root: str) -> str | None:
    """Newest ``*.trace.json.gz`` under ``root``; ``root`` itself when it
    is a file."""
    if os.path.isfile(root):
        return root
    paths = glob.glob(os.path.join(root, "**", "*.trace.json.gz"), recursive=True)
    if not paths:
        return None
    return max(paths, key=os.path.getmtime)


def _int_or_none(v):
    try:
        return None if v is None else int(v)
    except (TypeError, ValueError):
        return None


def load_trace(path: str) -> Trace:
    """Parse one chrome-trace JSON (optionally gzipped) into a Trace."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        raw = json.load(f)
    events: list = []
    process_names: dict = {}
    thread_names: dict = {}
    for e in raw.get("traceEvents", []):
        name = e.get("name", "")
        args = e.get("args") or {}
        if name == "process_name":
            process_names[_int_or_none(e.get("pid"))] = args.get("name", "")
            continue
        if name == "thread_name":
            thread_names[(_int_or_none(e.get("pid")), _int_or_none(e.get("tid")))] = \
                args.get("name", "")
            continue
        if e.get("ph") != "X" or not name:
            continue
        dur = float(e.get("dur", 0.0) or 0.0)
        if dur <= 0:
            continue
        events.append(TraceEvent(
            name=name, pid=_int_or_none(e.get("pid")) or 0,
            tid=_int_or_none(e.get("tid")) or 0,
            ts=float(e.get("ts", 0.0)), dur=dur, cat=str(e.get("cat", "")),
            correlation=_int_or_none(args.get("correlation")),
            external_id=_int_or_none(args.get("External id")),
        ))
    events.sort(key=lambda ev: ev.ts)
    return Trace(events=events, process_names=process_names,
                 thread_names=thread_names, path=path)
