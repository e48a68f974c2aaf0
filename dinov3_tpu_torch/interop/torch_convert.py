"""Meta's DINOv3 backbone weights (a release ``state_dict``) -> the port's
``DinoVisionTransformer`` (``dinov3_tpu/interop/torch_convert.py``).

The port's modules carry the release's names, so most entries load as
they are. What differs:
- ``rope_embed.*`` buffers and the qkv ``*.bias_mask`` are skipped: the
  RoPE periods are recomputed from the config, and ``mask_k_bias`` zeroes
  the k third of the qkv bias in the forward;
- SwiGLU: the release holds ``mlp.w1`` (gate), ``mlp.w2`` (value) and
  ``mlp.w3``; the port's ``SwiGLUFFN`` holds the fused ``mlp.w12`` whose
  rows are w1's then w2's (weights and biases), and ``mlp.w3`` as it is.
  (The JAX converter maps ``w1``/``w2`` one to one, so the JAX
  ``SwiGLUFFN``, which holds ``w12`` too, cannot load such a file.)

``load_backbone_from_meta`` checks the converted entries against the
model's own ``state_dict`` and reports missing, unexpected and
shape-mismatched names, as the JAX loader does; with ``strict`` it raises
on any.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_SKIP = (re.compile(r"^rope_embed\."), re.compile(r"\.bias_mask$"))
_SWIGLU_HALF = re.compile(r"^(.*\.mlp)\.w([12])\.(weight|bias)$")


def _to_tensor(v: Any) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def convert_meta_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A release ``state_dict`` (tensors or arrays) -> the port's names: the
    skipped entries dropped, each SwiGLU ``w1``/``w2`` pair fused into
    ``w12``. A lone half is kept under its own name (the check reports
    it)."""
    out: dict[str, torch.Tensor] = {}
    halves: dict[tuple, dict] = {}
    for name, value in state_dict.items():
        if any(p.search(name) for p in _SKIP):
            continue
        m = _SWIGLU_HALF.match(name)
        if m:
            halves.setdefault((m.group(1), m.group(3)), {})[m.group(2)] = (name, value)
            continue
        out[name] = _to_tensor(value)
    for (prefix, leaf), pair in halves.items():
        if set(pair) == {"1", "2"}:
            out[f"{prefix}.w12.{leaf}"] = torch.cat(
                [_to_tensor(pair["1"][1]), _to_tensor(pair["2"][1])], dim=0)
        else:
            out.update({n: _to_tensor(v) for n, v in pair.values()})
    return out


def load_backbone_from_meta(model: torch.nn.Module, state_dict: Mapping[str, Any],
                            strict: bool = True) -> dict:
    """Load a release ``state_dict`` into ``model`` (in place, each entry
    cast to the model's dtype for it). Returns {"missing", "unexpected",
    "mismatched"}, each a sorted list of names; with ``strict`` any of
    them raises ``ValueError`` naming the first few."""
    target = model.state_dict()
    got = convert_meta_state_dict(state_dict)
    report = {
        "missing": sorted(set(target) - set(got)),
        "unexpected": sorted(set(got) - set(target)),
        "mismatched": sorted(n for n in set(target) & set(got)
                             if tuple(target[n].shape) != tuple(got[n].shape)),
    }
    if strict and any(report.values()):
        raise ValueError(
            "Meta state_dict does not fit the model: "
            + " ".join(f"{k}={v[:8]}" for k, v in report.items()))
    bad = set(report["mismatched"])
    model.load_state_dict({n: v.to(target[n].dtype) for n, v in got.items()
                           if n in target and n not in bad}, strict=False)
    return report


def read_meta_weights(path: str) -> dict:
    """A release checkpoint file -> its ``state_dict`` on the CPU (a bare
    ``state_dict``, or one under a "model" or "state_dict" key; tensors
    only, as ``torch.load(weights_only=True)`` reads them)."""
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    for key in ("model", "state_dict"):
        if isinstance(sd, Mapping) and key in sd and isinstance(sd[key], Mapping):
            sd = sd[key]
    return dict(sd)
