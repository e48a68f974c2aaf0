"""Weights -> bf16 serving model (``dinov3_tpu/serve/weights.py``).

The serving model takes a Meta-named ``state_dict`` (released weights, or
a JAX tree bridged by ``interop/from_jax.py``) or, given none, a seeded
random init. Every floating parameter is then cast once to the serving
dtype, round-to-nearest-even like the JAX cast, so the same weights always
give the same serving model bitwise. Restoring a training checkpoint
comes with the checkpoint slice.
"""

from __future__ import annotations

import torch

from dinov3_tpu_torch.models import build_backbone
from dinov3_tpu_torch.ops.common import resolve_device


def cast_serving_tree(state_dict: dict, dtype=torch.bfloat16) -> dict:
    """Cast every floating tensor to the serving dtype; others pass.
    Idempotent and deterministic."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in state_dict.items()}


def load_serving_model(cfg, state_dict: dict | None = None, *,
                       device="cuda", seed: int = 0, dtype=torch.bfloat16):
    """The configured backbone with ``state_dict`` loaded (strictly) or a
    random init from ``seed``, cast to ``dtype``, on ``device``."""
    dev = resolve_device(device)
    model = build_backbone(cfg, device="cpu", seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.load_state_dict(cast_serving_tree(model.state_dict(), dtype),
                          assign=True)
    return model.requires_grad_(False).to(dev)
