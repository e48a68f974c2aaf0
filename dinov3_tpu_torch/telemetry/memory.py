"""Device memory accounting (``dinov3_tpu/telemetry/memory.py``).

- ``sample_memory()``: the caching allocator's own numbers on each card
  (``torch.cuda.memory_stats``: bytes in use and the peak), one record a
  device; none without a card. Sampled at set-up, after the first step
  and at each metrics flush (``SpanTracer.emit_memory``).
- ``per_device_state_bytes(state)``: the bytes a ``TrainState`` holds on
  each device: the parameters of student and EMA teacher, the Adam
  moments, the centers and the low-precision amax rings.

``layout_split`` (replicated against sharded bytes under assigned
shardings) waits with the sharded meshes (ROADMAP M7): on one card
every byte is the device's own.
"""

from __future__ import annotations

import torch


def sample_memory(devices=None) -> dict:
    """``{"devices": [{id, platform, bytes_in_use, peak_bytes_in_use,
    source}, ...]}`` over ``devices`` (default: every visible card)."""
    if not torch.cuda.is_available():
        return {"devices": []}
    ids = list(devices) if devices is not None else range(torch.cuda.device_count())
    out = []
    for d in ids:
        idx = torch.device(d).index if not isinstance(d, int) else d
        stats = torch.cuda.memory_stats(idx)
        out.append({
            "id": int(idx), "platform": "gpu",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "source": "torch.cuda.memory_stats",
        })
    return {"devices": out}


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def per_device_state_bytes(state) -> dict:
    """Bytes a ``TrainState`` holds per device: ``{"per_device": {device:
    bytes}, "total", "max_per_device", "parts": {part: bytes}}``, parts
    being ``params`` (student and teacher), ``opt_state``, ``center_state``
    and ``lowp``. Each storage counts once, however many views share it."""
    parts = {
        "params": list(state.meta.parameters()),
        "opt_state": [state.opt_state.mu, state.opt_state.nu],
        "center_state": state.center_state,
        "lowp": state.lowp,
    }
    seen: set = set()
    per_dev: dict = {}
    by_part: dict = {}
    for part, tree in parts.items():
        n_part = 0
        for t in _tensors(tree):
            key = (t.untyped_storage().data_ptr(), t.device)
            if key in seen:
                continue
            seen.add(key)
            nbytes = t.untyped_storage().nbytes()
            dev = str(t.device)
            per_dev[dev] = per_dev.get(dev, 0) + nbytes
            n_part += nbytes
        by_part[part] = n_part
    return {
        "per_device": per_dev,
        "total": sum(per_dev.values()),
        "max_per_device": max(per_dev.values()) if per_dev else 0,
        "parts": by_part,
    }
