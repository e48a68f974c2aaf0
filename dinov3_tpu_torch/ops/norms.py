"""Normalization layers with fp32 statistics (``dinov3_tpu/ops/norms.py``).

``LayerNorm`` runs through kernels K4 and K5 (``ops/fused_norm.py``,
forward and backward) on CUDA tensors and their plain versions on CPU
tensors. Parameters are named
``weight`` and ``bias`` as in Meta's ``state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from dinov3_tpu_torch.ops.fused_norm import fused_layernorm


class LayerNorm(nn.Module):
    """fp32 statistics, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layernorm(x.contiguous(), self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    """fp32 mean-square, learned scale."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + self.eps) * self.weight.float()).to(x.dtype)


def make_norm_layer(kind: str, dim: int) -> nn.Module:
    # "layernormbf16" keeps fp32 statistics, as the reference does
    if kind in ("layernorm", "layer_norm", "ln", "layernormbf16"):
        return LayerNorm(dim)
    if kind in ("rmsnorm", "rms_norm", "rms"):
        return RMSNorm(dim)
    raise ValueError(f"unknown norm layer {kind!r}")
