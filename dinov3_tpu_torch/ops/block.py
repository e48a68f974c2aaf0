"""Pre-norm transformer block with LayerScale (``dinov3_tpu/ops/block.py``),
the deterministic branch: stochastic depth is inert when serving."""

from __future__ import annotations

import torch
from torch import nn

from dinov3_tpu_torch.ops.attention import SelfAttention
from dinov3_tpu_torch.ops.ffn import make_ffn_layer
from dinov3_tpu_torch.ops.layer_scale import LayerScale
from dinov3_tpu_torch.ops.norms import make_norm_layer


class SelfAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_ratio: float = 4.0,
                 ffn_layer: str = "mlp", norm_layer: str = "layernorm",
                 qkv_bias: bool = True, proj_bias: bool = True,
                 ffn_bias: bool = True, layerscale_init: float | None = 1e-5,
                 mask_k_bias: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
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

    def forward(self, x: torch.Tensor, rope=None, seg=None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), rope=rope, seg=seg))
        return x + self.ls2(self.mlp(self.norm2(x)))
