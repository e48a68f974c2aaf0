"""LayerScale: learned per-channel residual scaling
(``dinov3_tpu/ops/layer_scale.py``)."""

from __future__ import annotations

import torch
from torch import nn


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)
