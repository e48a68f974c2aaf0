"""Weights -> bf16 serving model (``dinov3_tpu/serve/weights.py``).

The serving model takes a Meta-named ``state_dict`` (released weights, a
JAX tree bridged by ``interop/from_jax.py``, or a training state's
teacher backbone already on the card), the EMA teacher of a training
checkpoint directory (``ckpt_dir``), or, given none, a seeded random init.
Every floating parameter is then cast once to the serving dtype,
round-to-nearest-even like the JAX cast, so the same weights always give
the same serving model bitwise. Given weights, the model is built on the
``meta`` device and takes the cast tensors as its parameters: nothing is
drawn on the host, and a state on the card is cast there (the ViT-7B's
13.4 GB serving tree never crosses to the host).
"""

from __future__ import annotations

import logging

import torch

from dinov3_tpu_torch.logging_utils import LOGGER_NAME
from dinov3_tpu_torch.models import backbone_kwargs_from_cfg, build_model_for_eval, vit_ctor
from dinov3_tpu_torch.ops.common import resolve_device


def cast_serving_tree(state_dict: dict, dtype=torch.bfloat16) -> dict:
    """Cast every floating tensor to the serving dtype; others pass.
    Idempotent and deterministic."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in state_dict.items()}


def cast_to(t: torch.Tensor, dtype, device: torch.device) -> torch.Tensor:
    """One serving tensor: a floating ``t`` cast to ``dtype`` where it
    lies (on the host before the copy, so a host source never occupies
    the card in fp32), then moved to ``device``."""
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def load_serving_model(cfg, state_dict: dict | None = None, *,
                       ckpt_dir: str | None = None, device="cuda", seed: int = 0,
                       dtype=torch.bfloat16, meta_weights=None):
    """The configured backbone with ``state_dict`` loaded (strictly), or
    the EMA teacher of a training checkpoint under ``ckpt_dir``, or Meta
    release weights (``meta_weights``: a ``state_dict`` in Meta's names or
    its file; ``build_model_for_eval``), or a random init from ``seed``;
    cast to ``dtype``, on ``device``."""
    if (state_dict is not None) + bool(ckpt_dir) + (meta_weights is not None) > 1:
        raise ValueError("state_dict, ckpt_dir and meta_weights are alternatives: "
                         "pass one, not both of two")
    dev = resolve_device(device)
    if state_dict is None and not ckpt_dir:
        model = build_model_for_eval(cfg, device="cpu", seed=seed,
                                     meta_weights=meta_weights)
        model.load_state_dict(cast_serving_tree(model.state_dict(), dtype),
                              assign=True)
        return model.requires_grad_(False).to(dev)
    if ckpt_dir:
        from dinov3_tpu_torch.checkpoint import teacher_backbone_state_dict

        step, state_dict = teacher_backbone_state_dict(ckpt_dir)
        logging.getLogger(LOGGER_NAME).info(
            "serving model: EMA teacher backbone of step %d from %s", step, ckpt_dir)
    with torch.device("meta"):
        model = vit_ctor(cfg)(**backbone_kwargs_from_cfg(cfg))
    model.load_state_dict({k: cast_to(v, dtype, dev) for k, v in state_dict.items()},
                          strict=True, assign=True)
    return model.requires_grad_(False)
