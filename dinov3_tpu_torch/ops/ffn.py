"""Feed-forward layers (``dinov3_tpu/ops/ffn.py``): the standard ViT MLP
with exact (erf) GELU, and SwiGLU with one fused ``[gate | value]``
projection (``w12``) and its hidden width aligned to 8, 64 or 128
(``swiglu``, ``swiglu64``, ``swiglu128``). Their products go through
``ops/lowp.py lowp_dense`` (the fp8 / int8 arm while a scale is bound,
the legacy fp8 hook under ``fp8``, else bf16). MoE is not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dinov3_tpu_torch.ops.lowp import lowp_dense


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
        self.fp8 = False
        self.lowp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = exact_gelu(lowp_dense(self, "fc1", x, self.fc1.bias, self.dtype))
        return lowp_dense(self, "fc2", x, self.fc2.bias, self.dtype)


def swiglu_hidden_dim(hidden_dim: int, align_to: int = 8) -> int:
    """The 2/3 rule, rounded up to a multiple of ``align_to``."""
    d = int(hidden_dim * 2 / 3)
    return (d + align_to - 1) // align_to * align_to


class SwiGLUFFN(nn.Module):
    """``w3(silu(gate) * value)`` with ``[gate | value] = w12(x)``: one
    product for both halves, as the JAX ``SwiGLUFFN`` computes it. Meta's
    ``w1`` (gate) and ``w2`` (value) are the two halves of ``w12``'s rows
    (``interop/torch_convert.py``)."""

    def __init__(self, dim: int, hidden_dim: int, out_dim: int | None = None,
                 use_bias: bool = True, align_to: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.hidden = swiglu_hidden_dim(hidden_dim, align_to)
        self.w12 = nn.Linear(dim, 2 * self.hidden, bias=use_bias)
        self.w3 = nn.Linear(self.hidden, out_dim or dim, bias=use_bias)
        self.fp8 = False
        self.lowp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, value = lowp_dense(self, "w12", x, self.w12.bias, self.dtype).chunk(2, dim=-1)
        return lowp_dense(self, "w3", F.silu(gate) * value, self.w3.bias, self.dtype)


SWIGLU_ALIGN = {"swiglu": 8, "swiglu64": 64, "swiglu128": 128}


def make_ffn_layer(kind: str, dim: int, hidden_dim: int, **kwargs) -> nn.Module:
    if kind == "mlp":
        return Mlp(dim, hidden_dim, **kwargs)
    if kind in SWIGLU_ALIGN:
        return SwiGLUFFN(dim, hidden_dim, align_to=SWIGLU_ALIGN[kind], **kwargs)
    if kind == "moe":
        raise NotImplementedError(
            "ffn_layer='moe' is not ported yet: MoE comes with the tail slice "
            "of the port (ROADMAP M12)")
    raise ValueError(f"unknown ffn layer {kind!r}")
