"""Model factories from config (``dinov3_tpu/models/__init__.py``), ViT
only: ConvNeXt is not ported yet."""

from __future__ import annotations

import logging

import torch

from dinov3_tpu_torch.logging_utils import LOGGER_NAME
from dinov3_tpu_torch.models.vision_transformer import (
    ARCHS,
    DinoVisionTransformer,
    vit_large,
    vit_test,
)
from dinov3_tpu_torch.ops.common import Policy, resolve_device


def backbone_kwargs_from_cfg(cfg, *, teacher: bool = True) -> dict:
    """``student`` section -> ``DinoVisionTransformer`` kwargs. The teacher
    (and serve) backbone is deterministic: no drop path, no activation
    checkpointing. The student takes ``student.drop_path_rate`` and
    ``drop_path_mode``, and ``remat_mode(cfg)``. RoPE coordinate
    augmentation is not ported (the recipes leave it null; the training
    setup refuses it), and the TPU execution options (scan, sharding,
    kernel dispatch thresholds) do not apply."""
    s = cfg.student
    policy = Policy.from_cfg(cfg.compute_precision)
    return dict(
        remat="none" if teacher else remat_mode(cfg),
        patch_size=s.patch_size,
        drop_path_rate=0.0 if teacher else float(s.drop_path_rate),
        drop_path_mode=s.drop_path_mode,
        layerscale_init=s.layerscale,
        ffn_layer=s.ffn_layer,
        ffn_ratio=s.ffn_ratio,
        qkv_bias=s.qkv_bias,
        proj_bias=s.proj_bias,
        ffn_bias=s.ffn_bias,
        norm_layer=s.norm_layer,
        n_storage_tokens=s.n_storage_tokens,
        mask_k_bias=s.mask_k_bias,
        untie_cls_and_patch_norms=s.untie_cls_and_patch_norms,
        untie_global_and_local_cls_norm=s.untie_global_and_local_cls_norm,
        in_chans=s.in_chans,
        pos_embed_type=s.pos_embed_type,
        pos_embed_rope_base=s.pos_embed_rope_base,
        pos_embed_rope_min_period=s.pos_embed_rope_min_period,
        pos_embed_rope_max_period=s.pos_embed_rope_max_period,
        pos_embed_rope_normalize_coords=s.pos_embed_rope_normalize_coords,
        pos_embed_rope_dtype=s.pos_embed_rope_dtype,
        dtype=policy.compute_dtype,
    )


def remat_mode(cfg) -> str:
    """The student's activation checkpointing, as the JAX package maps it:
    ``train.checkpointing`` -> "blocks", ``train.checkpointing_full`` ->
    "full", and ``parallel.remat`` other than "none" overrides both."""
    train = cfg.train
    remat = {False: "none", True: "blocks"}.get(train.get("checkpointing", False), "none")
    if train.get("checkpointing_full", False):
        remat = "full"
    pr = str((cfg.get("parallel") or {}).get("remat", "none") or "none")
    if pr not in ("none", "attn", "blocks", "full"):
        raise ValueError(f"parallel.remat={pr!r}: expected none|attn|blocks|full")
    if pr != "none":
        remat = pr
    if remat == "attn":
        logging.getLogger(LOGGER_NAME).warning(
            "remat=attn has no effect: K1 (the flash-attention kernel) never "
            "materializes the [N, N] softmax state")
    return remat


def build_backbone(cfg, *, device="cuda", seed: int = 0) -> DinoVisionTransformer:
    """The configured (teacher/serve) ViT with a seeded random init, in the
    policy's parameter dtype, on ``device``. The init is drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed``, so the weights are the
    same whatever the device."""
    dev = resolve_device(device)
    arch = cfg.student.arch
    if arch.startswith("convnext"):
        raise NotImplementedError(
            f"student.arch={arch!r}: ConvNeXt is not ported yet (tail slice)")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    model = ARCHS[arch](**backbone_kwargs_from_cfg(cfg))
    model.init_weights(torch.Generator().manual_seed(seed))
    policy = Policy.from_cfg(cfg.compute_precision)
    return model.to(device=dev, dtype=policy.param_dtype).eval()


__all__ = [
    "ARCHS", "DinoVisionTransformer", "backbone_kwargs_from_cfg",
    "build_backbone", "remat_mode", "vit_large", "vit_test",
]
