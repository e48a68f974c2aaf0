"""Pre-norm transformer block with LayerScale and stochastic depth
(``dinov3_tpu/ops/block.py``).

Deterministic (teacher, serve) calls add both residual branches. A
training call with ``drop_path_rate > 0`` takes this block's slice of the
step's drop-path plan (``rng/plan.py``): ``{"idx": [2, keep]}`` runs each
branch on its kept rows only (``subset_residual_planned``), with the rows'
own RoPE tables and segment ids gathered alongside; ``{"keep": [2, B]}``
masks whole rows (``mask_residual_planned``).

``remat_forward`` runs a block under activation checkpointing, the port
of ``remat_block_cls``.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from dinov3_tpu_torch.ops.attention import SelfAttention
from dinov3_tpu_torch.ops.drop_path import (
    mask_residual_planned,
    subset_residual_planned,
)
from dinov3_tpu_torch.ops.ffn import make_ffn_layer
from dinov3_tpu_torch.ops.layer_scale import LayerScale
from dinov3_tpu_torch.ops.norms import make_norm_layer


class SelfAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_ratio: float = 4.0,
                 ffn_layer: str = "mlp", norm_layer: str = "layernorm",
                 qkv_bias: bool = True, proj_bias: bool = True,
                 ffn_bias: bool = True, layerscale_init: float | None = 1e-5,
                 mask_k_bias: bool = False, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = make_norm_layer(norm_layer, dim)
        self.attn = SelfAttention(dim, num_heads, qkv_bias=qkv_bias,
                                  proj_bias=proj_bias, mask_k_bias=mask_k_bias,
                                  dtype=dtype)
        self.norm2 = make_norm_layer(norm_layer, dim)
        self.mlp = make_ffn_layer(ffn_layer, dim, int(dim * ffn_ratio),
                                  use_bias=ffn_bias, dtype=dtype)
        if layerscale_init is not None:
            self.ls1 = LayerScale(dim, layerscale_init)
            self.ls2 = LayerScale(dim, layerscale_init)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor, rope=None, seg=None,
                plan: dict | None = None) -> torch.Tensor:
        """``plan``: this block's drop-path slice, given on training calls
        (required there when ``drop_path_rate > 0``), None otherwise."""

        def attn_branch(t, aux=None):
            r, s = (rope, seg) if aux is None else (aux["rope"], aux["seg"])
            return self.ls1(self.attn(self.norm1(t), rope=r, seg=s))

        def mlp_branch(t, aux=None):
            return self.ls2(self.mlp(self.norm2(t)))

        if plan is None or self.drop_path_rate == 0.0:
            x = x + attn_branch(x)
            return x + mlp_branch(x)
        if "idx" in plan:
            # per-row context rides the subset gather with its rows
            aux = {"rope": rope, "seg": seg} if seg is not None else None
            x = subset_residual_planned(x, attn_branch, plan["idx"][0], aux)
            return subset_residual_planned(x, mlp_branch, plan["idx"][1], aux)
        x = mask_residual_planned(x, attn_branch(x), plan["keep"][0],
                                  self.drop_path_rate)
        return mask_residual_planned(x, mlp_branch(x), plan["keep"][1],
                                     self.drop_path_rate)


REMAT_MODES = ("none", "attn", "blocks", "full")
# the weight matmuls of a block (qkv, proj, fc1, fc2): ``dense`` reaches
# them as 2-D products; attention's products run inside K1-K3
_WEIGHT_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_forward(block: nn.Module, remat: str):
    """``block``'s forward under activation checkpointing
    (``dinov3_tpu/ops/block.py remat_block_cls``), for calls that build a
    graph: "full" saves only the block's inputs and recomputes the whole
    block in the backward; "blocks" also saves the outputs of the weight
    matmuls (``dots_with_no_batch_dims_saveable``) and recomputes the
    rest, K1 and K4 included; "none" and "attn" return the block itself
    ("attn" spares the dense attention's [N, N] probabilities in the
    reference, which K1 never materializes). The blocks draw no randomness
    (drop path comes from the step's plan), so no RNG state is kept."""
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {remat!r}; expected none|attn|blocks|full")
    if remat in ("none", "attn"):
        return block
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_weight_matmuls)
                  if remat == "blocks" else noop_context_fn)

    def run(x, **kwargs):
        return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn, **kwargs)

    return run
