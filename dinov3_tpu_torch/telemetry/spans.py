"""The steady-state ``--benchmark`` timer (``dinov3_tpu/telemetry/spans.py``
``StepTimer``)."""

from __future__ import annotations

import time

import torch


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
