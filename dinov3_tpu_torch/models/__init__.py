"""Model factories from config (``dinov3_tpu/models/__init__.py``), ViT
only: ConvNeXt is not ported yet."""

from __future__ import annotations

import logging
import os

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
    ``drop_path_mode``, ``remat_mode(cfg)`` and the RoPE coordinate
    augmentation settings (which only a training forward applies). The TPU execution options (scan, sharding, kernel dispatch
    thresholds) do not apply (``configs/config.py check_train_slice``)."""
    s = cfg.student
    policy = Policy.from_cfg(cfg.compute_precision)
    # an override "+student.n_blocks=N" (a key the schema lacks) cuts the
    # arch's depth, for smoke runs at full width
    depth = {} if s.get("n_blocks") is None else {"n_blocks": int(s.n_blocks)}
    return dict(**depth,
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
        pos_embed_rope_shift_coords=None if teacher else s.get("pos_embed_rope_shift_coords"),
        pos_embed_rope_jitter_coords=None if teacher else s.get("pos_embed_rope_jitter_coords"),
        pos_embed_rope_rescale_coords=None if teacher else s.get("pos_embed_rope_rescale_coords"),
        pos_embed_rope_dtype=s.pos_embed_rope_dtype,
        dtype=policy.compute_dtype,
    )


def fp8_blocks(cfg) -> bool:
    """``student.fp8_enabled``: the student's block products through the
    legacy fp8 hook (``ops/common.py fp8_matmul``) when ``fp8_filter``
    matches ``blocks`` (the one granularity the reference supports; a
    filter that misses it logs and leaves fp8 off). The teacher never."""
    import re

    s = cfg.student
    if not bool(s.get("fp8_enabled", False)):
        return False
    filt = str(s.get("fp8_filter", "blocks") or "")
    on = bool(re.search(filt, "blocks")) if filt else True
    if not on:
        logging.getLogger(LOGGER_NAME).warning(
            "student.fp8_enabled=true but fp8_filter=%r does not match 'blocks' "
            "(the supported granularity is the whole block stack) — fp8 is OFF", filt)
    return on


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


def build_model_for_eval(cfg, ckpt_dir: str | None = None, *, device="cuda",
                         seed: int = 0, meta_weights=None) -> DinoVisionTransformer:
    """The teacher backbone for feature extraction and evals, frozen, on
    ``device``. With ``ckpt_dir`` (a trainer's ``<output-dir>/ckpt``, of
    this package or the JAX package's local-npz kind) it holds the EMA
    teacher's backbone of the latest finalized step, loaded strictly; with
    ``meta_weights`` (a Meta release ``state_dict``, or the path of its
    file) those weights, converted and loaded strictly
    (``interop/torch_convert.py``); with neither, the seeded random init of
    ``build_backbone``."""
    if ckpt_dir and meta_weights is not None:
        raise ValueError("pass ckpt_dir or meta_weights, not both")
    dev = resolve_device(device)
    model = build_backbone(cfg, device="cpu", seed=seed)
    if meta_weights is not None:
        from dinov3_tpu_torch.interop.torch_convert import (
            load_backbone_from_meta,
            read_meta_weights,
        )

        sd = (read_meta_weights(meta_weights) if isinstance(meta_weights, (str, os.PathLike))
              else meta_weights)
        load_backbone_from_meta(model, sd, strict=True)
        logging.getLogger(LOGGER_NAME).info("eval model: Meta-layout weights (%d entries)",
                                            len(sd))
    if ckpt_dir:
        from dinov3_tpu_torch.checkpoint import teacher_backbone_state_dict

        step, state_dict = teacher_backbone_state_dict(ckpt_dir)
        model.load_state_dict(state_dict, strict=True)
        logging.getLogger(LOGGER_NAME).info(
            "eval model: EMA teacher backbone of step %d from %s", step, ckpt_dir)
    return model.requires_grad_(False).to(dev)


__all__ = [
    "ARCHS", "DinoVisionTransformer", "backbone_kwargs_from_cfg",
    "build_backbone", "build_model_for_eval", "remat_mode", "vit_large",
    "vit_test",
]
