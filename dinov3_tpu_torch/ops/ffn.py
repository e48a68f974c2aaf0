"""Feed-forward layers (``dinov3_tpu/ops/ffn.py``): the standard ViT MLP
with exact (erf) GELU. SwiGLU and MoE are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dinov3_tpu_torch.ops.common import dense


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf GELU, what torch ``nn.GELU()`` and Meta's DINOv3 compute."""
    return F.gelu(x, approximate="none")


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int | None = None,
                 use_bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden_dim, bias=use_bias)
        self.fc2 = nn.Linear(hidden_dim, out_dim or dim, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = exact_gelu(dense(x, self.fc1.weight, self.fc1.bias, self.dtype))
        return dense(x, self.fc2.weight, self.fc2.bias, self.dtype)


def make_ffn_layer(kind: str, dim: int, hidden_dim: int, **kwargs) -> nn.Module:
    if kind == "mlp":
        return Mlp(dim, hidden_dim, **kwargs)
    if kind in ("swiglu", "swiglu64", "swiglu128", "moe"):
        raise NotImplementedError(
            f"ffn_layer={kind!r} is not ported yet: SwiGLU comes with the "
            "ViT-7B slice and MoE with the tail slice of the port")
    raise ValueError(f"unknown ffn layer {kind!r}")
