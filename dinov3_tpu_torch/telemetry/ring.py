"""The on-device metrics ring (``dinov3_tpu/telemetry/ring.py``).

The training launch writes its scalar metrics into a ``[K, M]`` fp32
buffer on the device (K = ``telemetry.flush_every``, M metrics): one
``index_copy_`` a step into slot ``iteration % K`` under
``record_function("telemetry_ring")``, an int32 iteration stamp per row,
and an int32 device-side streak of consecutive steps whose
``total_loss`` was not finite. Nothing crosses to the host per step; the
host flushes the ring once per K steps with one ``blocking_fetch`` and
replays the rows, iteration-stamped, into the meters, the loss recorder
and the comparator. The streak keeps the reference's ring layout: it is
the run of non-finite steps at the last write only. The trainer's
3-strike abort counts the flushed losses on the host instead, across
flushes, so three non-finite steps followed by a finite one inside a
window still abort; it comes at flush latency (up to K - 1 steps late).

Resume mid-ring: the slot is ``iteration % K`` and rows carry their
iteration, so a restart at an iteration not aligned to K begins a
partial window; ``RingReader`` starts its cursor at the restored
iteration. A stamp mismatch raises: it comes only from a flush window
wider than the ring or a cursor that drifted, never from wraparound.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RingState(NamedTuple):
    """Device-side telemetry state, updated in place by ``write_row``."""

    buf: torch.Tensor               # [K, M] fp32 metric rows
    its: torch.Tensor               # [K] int32 iteration of each row (-1: unwritten)
    nonfinite_streak: torch.Tensor  # [] int32 consecutive non-finite total_loss steps


def make_ring(n_metrics: int, ring_len: int, device="cpu") -> RingState:
    """A zeroed ring on ``device``."""
    if ring_len < 1:
        raise ValueError(f"telemetry ring length must be >= 1, got {ring_len}")
    return RingState(
        buf=torch.zeros((ring_len, n_metrics), dtype=torch.float32, device=device),
        its=torch.full((ring_len,), -1, dtype=torch.int32, device=device),
        nonfinite_streak=torch.zeros((), dtype=torch.int32, device=device),
    )


def write_row(ring: RingState, iteration: int, values: torch.Tensor,
              loss_col: int) -> RingState:
    """Write one step's ``values`` ([M], on the ring's device) into slot
    ``iteration % K`` and advance the streak from column ``loss_col``
    (``total_loss``), all on the device with no host read. ``iteration``
    is the step's own counter (before its increment). The ring holds the
    exact fp32 values the one-read-a-step path would read, so the two
    agree bit for bit."""
    if values.shape != ring.buf.shape[1:]:
        raise ValueError(f"telemetry ring rows hold {ring.buf.shape[1]} scalar "
                         f"metrics; got values of shape {tuple(values.shape)}")
    k = ring.its.shape[0]
    with torch.profiler.record_function("telemetry_ring"):
        # the slot index is filled on the device: no host-to-device copy
        slot = torch.full((1,), iteration % k, dtype=torch.long, device=ring.buf.device)
        ring.buf.index_copy_(0, slot, values.detach().float()[None])
        ring.its.index_fill_(0, slot, int(iteration))
        finite = torch.isfinite(values[loss_col].detach())
        ring.nonfinite_streak.add_(1).mul_(~finite)
    return ring


class RingReader:
    """Host-side consumer: one blocking fetch a flush, rows replayed in
    iteration order.

    ``flush(ring, upto)`` returns ``(iterations [n] int64, rows [n, M]
    float32, nonfinite_streak int)`` for iterations ``[cursor, upto)`` and
    advances the cursor; asking for a window wider than the ring raises.
    """

    def __init__(self, names, ring_len: int, start_iteration: int = 0):
        self.names = list(names)
        self.ring_len = int(ring_len)
        self.cursor = int(start_iteration)

    def flush(self, ring: RingState, upto_iteration: int):
        from dinov3_tpu_torch.telemetry.host_sync import blocking_fetch

        upto = int(upto_iteration)
        n = upto - self.cursor
        if n < 0 or n > self.ring_len:
            raise RuntimeError(
                f"telemetry flush window [{self.cursor}, {upto}) does not "
                f"fit the ring (K={self.ring_len}); flush at least every "
                "K steps"
            )
        # one copy: rows, stamps and streak widened to float64, which holds
        # each fp32 value and each int32 exactly
        flat = blocking_fetch(torch.cat([
            ring.buf.reshape(-1).double(), ring.its.double(),
            ring.nonfinite_streak.reshape(1).double()])).numpy()
        m = ring.buf.shape[1]
        buf = flat[: self.ring_len * m].reshape(self.ring_len, m).astype(np.float32)
        its = flat[self.ring_len * m: -1].astype(np.int32)
        streak = int(flat[-1])
        out_its = np.arange(self.cursor, upto, dtype=np.int64)
        slots = out_its % self.ring_len
        got = its[slots]
        if not np.array_equal(got, out_its.astype(np.int32)):
            raise RuntimeError(
                "telemetry ring stamp mismatch: expected iterations "
                f"{out_its.tolist()} at slots {slots.tolist()}, ring holds "
                f"{got.tolist()} — reader cursor drifted from the device "
                "ring (structural bug, not wraparound)"
            )
        rows = buf[slots]
        self.cursor = upto
        return out_its, rows, streak
