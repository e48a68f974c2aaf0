"""Heartbeat files and the flush-window watchdog
(``dinov3_tpu/telemetry/watchdog.py``).

Liveness is a heartbeat file whose mtime a live process keeps advancing
(``SpanTracer.beat``); a stalled one (a wedged serve queue, a hung data
loader) stops. The files are role-namespaced, ``heartbeat.<role>[.rankN]``
(role ``train`` | ``serve`` | anything), so a trainer and a serve engine
sharing one output dir never overwrite each other's signal;
``read_heartbeat`` falls back to the un-namespaced ``heartbeat[.rankN]``
of older runs. ``scan_heartbeats`` reports every heartbeat under an
output dir with its age, for supervisors that poll. ``Watchdog.window``
times a flush window and emits a ``stall`` span into the tracer's stream
when the window outlasts its deadline. (The preemption span chain of the
reference waits with ``run/preemption.py``, ROADMAP M12.)
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time

_HB_RE = re.compile(
    r"heartbeat(?:\.(?!rank\d+$)(?P<role>[A-Za-z0-9_-]+))?"
    r"(?:\.rank(?P<rank>\d+))?$")


def heartbeat_path(output_dir: str, role: str = "train",
                   rank: int = 0) -> str:
    """The namespaced heartbeat path SpanTracer writes."""
    suffix = "" if rank == 0 else f".rank{rank}"
    return os.path.join(output_dir, "telemetry", f"heartbeat.{role}{suffix}")


def legacy_heartbeat_path(output_dir: str, rank: int = 0) -> str:
    """The un-namespaced path of older runs (read only)."""
    suffix = "" if rank == 0 else f".rank{rank}"
    return os.path.join(output_dir, "telemetry", f"heartbeat{suffix}")


def read_heartbeat(output_dir: str, role: str = "train",
                   rank: int = 0) -> dict | None:
    """Read one heartbeat: namespaced first, legacy fallback.

    Returns ``{"path", "mtime", "iteration", "t", "legacy"}`` or None
    when neither file exists. The payload (iteration + wall time) is
    advisory; MTIME is the liveness signal."""
    for path, legacy in ((heartbeat_path(output_dir, role, rank), False),
                         (legacy_heartbeat_path(output_dir, rank), True)):
        try:
            st = os.stat(path)
        except FileNotFoundError:
            continue
        out = {"path": path, "mtime": st.st_mtime, "legacy": legacy,
               "iteration": None, "t": None}
        try:
            with open(path) as f:
                beat = json.load(f)
            out["iteration"] = beat.get("iteration")
            out["t"] = beat.get("t")
        except (OSError, ValueError):
            pass  # mid-write or torn file: mtime alone still answers
        return out
    return None


def scan_heartbeats(output_dir: str, stale_after_s: float = 0.0,
                    now: float | None = None) -> list[dict]:
    """Every heartbeat under ``output_dir/telemetry`` with its age.

    Each row: ``{"role", "rank", "age_s", "stalled", ...read_heartbeat
    fields}``; legacy un-namespaced files report role "train" (the only
    writer that ever produced them) with ``legacy=True``. A namespaced
    file shadows the legacy one for the same (role, rank).
    ``stalled`` is ``age_s > stale_after_s`` when a threshold is given,
    else False."""
    now = time.time() if now is None else now
    rows: dict[tuple, dict] = {}
    for path in sorted(glob.glob(
            os.path.join(output_dir, "telemetry", "heartbeat*"))):
        m = _HB_RE.match(os.path.basename(path))
        if not m:
            continue
        role = m.group("role") or "train"
        rank = int(m.group("rank") or 0)
        legacy = m.group("role") is None
        key = (role, rank)
        if key in rows and not rows[key]["legacy"]:
            continue  # namespaced beat shadows the legacy file
        st = os.stat(path)
        age = max(0.0, now - st.st_mtime)
        rows[key] = {
            "role": role, "rank": rank, "path": path, "legacy": legacy,
            "mtime": st.st_mtime, "age_s": round(age, 3),
            "stalled": bool(stale_after_s and age > stale_after_s),
        }
    return [rows[k] for k in sorted(rows)]


class Watchdog:
    """In-process flush-window deadline keeper.

    ``window(label, deadline_s)`` times a with-block; when the block's
    wall time exceeds the deadline, a ``stall`` record
    (``{"name": "stall", "window": label, "dur_ms", "deadline_ms"}``)
    is emitted through the tracer and counted. ``deadline_s`` <= 0
    disables the check for that window (the span is still free — the
    wrapped code times itself). The tracer may be None (counting
    only)."""

    def __init__(self, tracer=None, deadline_s: float = 0.0):
        self.tracer = tracer
        self.deadline_s = float(deadline_s)
        self.stalls = 0

    @contextlib.contextmanager
    def window(self, label: str, deadline_s: float | None = None,
               **fields):
        deadline = self.deadline_s if deadline_s is None else float(
            deadline_s)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            if deadline > 0 and dur > deadline:
                self.stalls += 1
                if self.tracer is not None:
                    self.tracer.emit({
                        "name": "stall", "window": label,
                        "t": round(time.time(), 6),
                        "dur_ms": round(dur * 1e3, 4),
                        "deadline_ms": round(deadline * 1e3, 4),
                        **fields,
                    })
