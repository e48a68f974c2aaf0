"""Multi-head self-attention with RoPE (``dinov3_tpu/ops/attention.py``).

``SelfAttention`` runs one fused qkv projection, optionally zeroes the k
third of its bias (``mask_k_bias``), rotates q and k, and sends every
attention call to ``ops/flash_attention.py`` (K1 forward, K2 and K3
backward): on CUDA tensors the Hopper kernels, on CPU tensors their
plain versions (``attention_plain``, the port of the JAX
``xla_attention`` with ``seg``: dense fp32 softmax, masked logits -1e30;
``attention_bwd_plain``).
"""

from __future__ import annotations

import torch
from torch import nn

from dinov3_tpu_torch.ops.common import dense
from dinov3_tpu_torch.ops.flash_attention import flash_attention
from dinov3_tpu_torch.ops.rope import rope_apply_full


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True,
                 proj_bias: bool = True, mask_k_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.mask_k_bias = mask_k_bias
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim, bias=proj_bias)

    def forward(self, x: torch.Tensor, rope=None, seg=None) -> torch.Tensor:
        """x [B, N, D]; rope (sin, cos) [N, hd] or [B, N, hd]; seg [B, N]."""
        B, N, _ = x.shape
        h, d = self.num_heads, self.dim // self.num_heads
        bias = self.qkv.bias
        if bias is not None and self.mask_k_bias:
            # zero the k third (reference: LinearKMaskedBias)
            mask = torch.ones_like(bias)
            mask[self.dim: 2 * self.dim] = 0
            bias = bias * mask
        qkv = dense(x, self.qkv.weight, bias, self.dtype)
        q = qkv[..., : self.dim].reshape(B, N, h, d)
        k = qkv[..., self.dim: 2 * self.dim].reshape(B, N, h, d)
        v = qkv[..., 2 * self.dim:].reshape(B, N, h, d)
        if rope is not None:
            q, k = rope_apply_full(q, k, *rope)
        out, _ = flash_attention(q, k, v, seg)
        return dense(out.reshape(B, N, self.dim), self.proj.weight,
                     self.proj.bias, self.dtype)
