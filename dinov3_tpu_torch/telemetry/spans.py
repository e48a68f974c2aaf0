"""Host phase spans, the per-process heartbeat and the ``--benchmark``
timer (``dinov3_tpu/telemetry/spans.py``).

``SpanTracer`` records monotonic-clock spans as JSON lines in
``<output-dir>/telemetry/spans[.<role>][.rankN].jsonl``:

    {"name": "serve_device", "pack": 17, "t": <epoch s>, "dur_ms": 1.84,
     "v": 1, "role": "serve"}

Durations come from ``time.perf_counter``; ``t`` is wall epoch time, for
aligning processes only. Every record carries the schema version
(``SPAN_SCHEMA_V``) and the tracer's role. The train role keeps the
un-suffixed file; other roles (serve) write ``spans.<role>.jsonl`` beside
it, so a trainer and a serve engine sharing an output dir never interleave
lines. The heartbeat file (``heartbeat.<role>[.rankN]``) is rewritten at
most once per ``heartbeat_every`` iterations; its mtime is the liveness
signal (``watchdog.py``). Records are buffered and flushed by ``beat``,
``close`` and every ``flush_every_emits`` records.

Memory samples ride the same stream as ``{"name": "memory", "point":
"flush", ...}`` records (``telemetry/memory.py``).

The ``--profile-steps a,b`` window is folded in: ``profile_step_begin(a)``
starts ``torch.profiler.profile`` (CPU and, with a card, CUDA activity;
no shapes) and ``profile_step_end(b)`` synchronizes the card, stops it
and exports Kineto's chrome trace gzipped to
``<profile_dir>/<host>_<pid>.trace.json.gz``; while it is open,
``step_annotation(it)`` marks each iteration with
``record_function("train_step#<it>")``, which ``telemetry/anatomy.py``
cuts steps by. ``StepTimer`` times ``--benchmark``; a run never overlaps
the two windows (the profiler costs time inside its window).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time

import torch

# the trainer's hot-loop phase names (one vocabulary with the reference)
PHASES = (
    "data_wait", "h2d", "dispatch", "metrics_fetch", "metrics_flush",
    "gram_refresh", "eval", "checkpoint_save",
)

# the serve-side phase names, in the order a request meets them: queue
# wait, FFD placement and plane fill, dispatch, device compute fenced by
# the fetch, the fetch, response extraction (``serve_obs.py`` emits them)
SERVE_PHASES = (
    "serve_enqueue", "serve_pack_placement", "serve_dispatch",
    "serve_device", "serve_fetch", "serve_extract",
)

# stamped on every span record, so readers gate on it
SPAN_SCHEMA_V = 1


class SpanTracer:
    """JSONL span recorder and heartbeat. ``enabled=False`` (or no
    ``output_dir``) makes every method a no-op."""

    def __init__(self, output_dir: str | None, rank: int = 0,
                 enabled: bool = True, heartbeat_every: int = 1,
                 profile_steps: tuple[int, int] | None = None,
                 profile_dir: str | None = None, role: str = "train",
                 flush_every_emits: int = 32):
        self.enabled = bool(enabled and output_dir)
        self.heartbeat_every = max(1, int(heartbeat_every))
        self.role = str(role)
        # bounded auto-flush: a crash between beats loses at most
        # flush_every_emits - 1 trailing records (0: only beat/close flush)
        self.flush_every_emits = max(0, int(flush_every_emits))
        self._emits_since_flush = 0
        self._profile = profile_steps
        self._profile_dir = profile_dir
        self._prof = None
        self._recording = False
        self.trace_path = None
        self._f = None
        self.spans_path = self.heartbeat_path = None
        if not self.enabled:
            return
        tdir = os.path.join(output_dir, "telemetry")
        os.makedirs(tdir, exist_ok=True)
        suffix = "" if rank == 0 else f".rank{rank}"
        rpart = "" if self.role == "train" else f".{self.role}"
        self.spans_path = os.path.join(tdir, f"spans{rpart}{suffix}.jsonl")
        self.heartbeat_path = os.path.join(
            tdir, f"heartbeat.{self.role}{suffix}")
        self._f = open(self.spans_path, "a")

    # ---- spans ----

    @contextlib.contextmanager
    def span(self, name: str, iteration: int | None = None, **fields):
        """Time a block as one span record; ``fields`` ride the record."""
        if not self.enabled:
            yield
            return
        t_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit({
                "name": name,
                "iteration": None if iteration is None else int(iteration),
                "t": round(t_wall, 6),
                "dur_ms": round((time.perf_counter() - t0) * 1e3, 4),
                **fields,
            })

    def emit(self, record: dict) -> None:
        """Append one JSONL record stamped with the schema version and
        this tracer's role."""
        if self._f is None:
            return
        record.setdefault("v", SPAN_SCHEMA_V)
        record.setdefault("role", self.role)
        self._f.write(json.dumps(record) + "\n")
        if self.flush_every_emits:
            self._emits_since_flush += 1
            if self._emits_since_flush >= self.flush_every_emits:
                self._f.flush()
                self._emits_since_flush = 0

    def wrap_iter(self, iterable, name: str = "data_wait",
                  start_iteration: int = 0):
        """Time each ``next()`` of ``iterable`` as a span."""
        if not self.enabled:
            yield from iterable
            return
        it = iter(iterable)
        i = int(start_iteration)
        while True:
            with self.span(name, i):
                try:
                    obj = next(it)
                except StopIteration:
                    return
            yield obj
            i += 1

    # ---- heartbeat ----

    def beat(self, iteration: int) -> None:
        """Advance the heartbeat file's mtime (at most once per
        ``heartbeat_every`` iterations) and flush buffered spans."""
        if not self.enabled or iteration % self.heartbeat_every:
            return
        self._f.flush()
        self._emits_since_flush = 0
        with open(self.heartbeat_path, "w") as hb:
            hb.write(json.dumps(
                {"iteration": int(iteration), "t": round(time.time(), 6)}))

    # ---- memory samples (ride the span stream) ----

    def emit_memory(self, point: str, iteration: int | None = None) -> None:
        """One ``memory`` record (``telemetry/memory.py sample_memory``):
        the allocator's bytes in use and peak on each card, no device
        entry without one."""
        if not self.enabled:
            return
        from dinov3_tpu_torch.telemetry.memory import sample_memory

        self.emit({
            "name": "memory", "point": point,
            "iteration": None if iteration is None else int(iteration),
            "t": round(time.time(), 6), **sample_memory(),
        })

    # ---- profiler window (--profile-steps) ----

    def profile_step_begin(self, iteration: int) -> None:
        """The profiler window ``(a, b)``: opened at iteration a - 1 in its
        warm-up state, which turns the device tracing on but keeps
        nothing, so that iteration launches every kernel once under it;
        recording from iteration a on, after the card has finished
        iteration a - 1 and a few small launches and a pause have taken
        the first moments of recording, outside every step. Kineto drops
        launches after a start, so without this the window's first step
        would come out short. Where a is the run's first iteration, the
        warm-up is one small launch. Its steps a..b are each whole."""
        if not self._profile or self._recording:
            return
        a = self._profile[0]
        cuda = torch.cuda.is_available()
        if self._prof is None and iteration in (a - 1, a):
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            n = self._profile[1] - a + 1
            self._prof = torch.profiler.profile(
                activities=acts, record_shapes=False,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1))
            # the windows are the trainer's train_step#N annotations, not
            # the schedule's ProfilerStep#N (which would span the window)
            self._prof.record_steps = False
            self._prof.start()  # warm-up: tracing on, nothing kept
            if iteration == a - 1:
                return
            if cuda:
                torch.ones(1, device="cuda").add_(1)
        if iteration != a:
            return
        if cuda:
            torch.cuda.synchronize()
        self._prof.step()  # recording from here to profile_step_end
        self._recording = True
        if cuda:
            for _ in range(8):
                torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            time.sleep(0.1)
        self.emit({"name": "profile_start", "iteration": int(iteration),
                   "t": round(time.time(), 6)})

    def step_annotation(self, iteration: int):
        """``record_function("train_step#<iteration>")`` while the window
        is open, else a no-op context."""
        if not self._recording:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"train_step#{int(iteration)}")

    def profile_step_end(self, iteration: int, state=None) -> str | None:
        """At the window's last iteration: wait for the card's queued
        work, stop the profiler and export its trace; returns the path."""
        if not self._recording or iteration != self._profile[1]:
            return None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self._profile_dir, f"{socket.gethostname()}_{os.getpid()}.trace.json.gz")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof, self._recording = None, False
        self.emit({"name": "profile_stop", "iteration": int(iteration),
                   "t": round(time.time(), 6), "trace_path": self.trace_path})
        return self.trace_path

    def close(self) -> None:
        if self._prof is not None:  # a run that ended inside its window
            self._prof.stop()
            self._prof, self._recording = None, False
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


class StepTimer:
    """Times the last ``n_steps`` of ``total_iters`` iterations. ``mark``
    fences first (``torch.cuda.synchronize()`` on the card; nothing on the
    CPU, where the step has finished when it returns) and then takes its
    timestamp, so each interval is one completed step. One extra leading
    mark gives N measured intervals. ``exclude(seconds)`` takes time spent
    between two marks outside the steps (a synchronous checkpoint save)
    out of the interval it fell in."""

    def __init__(self, n_steps: int, total_iters: int, device=None):
        self.n = max(0, int(n_steps))
        self.total = int(total_iters)
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.intervals: list[float] = []  # seconds per measured step
        self._last: float | None = None
        self._excluded = 0.0

    def active(self, iteration: int) -> bool:
        return bool(self.n) and iteration >= self.total - self.n - 1

    def mark(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        if self._last is not None:
            self.intervals.append(now - self._last - self._excluded)
        self._last, self._excluded = now, 0.0

    def exclude(self, seconds: float) -> None:
        if self._last is not None:
            self._excluded += seconds

    @property
    def n_intervals(self) -> int:
        return len(self.intervals)

    def ms_per_step(self) -> float | None:
        if not self.intervals:
            return None
        return sum(self.intervals) / len(self.intervals) * 1e3

    def img_per_sec(self, global_batch: int) -> float | None:
        ms = self.ms_per_step()
        return None if ms is None else global_batch / ms * 1e3
