"""The counted device-to-host fetch funnel (``dinov3_tpu/telemetry/host_sync.py``).

Every blocking device-to-host read of the serve engines goes through
``blocking_fetch``, which counts calls and the wall time the host spent
blocked in them, so "one fetch a pack" is read off a counter. A fetch is
one ``.cpu()``: a tuple of tensors of one dtype is flattened into one
device buffer first, so it still costs one copy and one wait. The blocked
time includes any device work the fetched values still wait on; that is
the point (the packed engine's ``device`` and ``fetch`` phases are this
wait).
"""

from __future__ import annotations

import time

import torch

_STATS = {"fetches": 0, "blocked_s": 0.0}


def _fetch(tensors):
    if isinstance(tensors, torch.Tensor):
        return tensors.cpu()
    tensors = tuple(tensors)
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("blocking_fetch reads a tuple of one dtype in one copy; got "
                         f"{[t.dtype for t in tensors]}")
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu()
    return tuple(p.view(t.shape) for p, t in
                 zip(flat.split([t.numel() for t in tensors]), tensors))


def blocking_fetch(tensors):
    """A tensor, or a tuple of tensors, on the host: one blocking call,
    counted with its host-blocked wall time. Returns CPU tensors in the
    same structure."""
    t0 = time.perf_counter()
    out = _fetch(tensors)
    _STATS["fetches"] += 1
    _STATS["blocked_s"] += time.perf_counter() - t0
    return out


def host_sync_stats(reset: bool = False) -> dict:
    """{"fetches": n, "blocked_ms": host-blocked wall ms} since the last
    reset; ``reset=True`` zeroes the counters after reading."""
    out = {
        "fetches": _STATS["fetches"],
        "blocked_ms": round(_STATS["blocked_s"] * 1e3, 3),
    }
    if reset:
        _STATS["fetches"] = 0
        _STATS["blocked_s"] = 0.0
    return out
