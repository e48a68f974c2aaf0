"""DINO/iBOT projection head (``dinov3_tpu/ops/dino_head.py``).

n-layer GELU MLP -> bottleneck -> fp32 L2 normalize -> fp32 prototype
product (no bias). Parameters carry Meta's names: ``mlp.0/2/4`` (Linear
layers between GELUs) and ``last_layer.weight`` [K, bottleneck]. The MLP
runs in the compute dtype through ``dense``; its GELU is the tanh form,
as the JAX head's ``nn.gelu`` default computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dinov3_tpu_torch.ops.common import dense, l2_normalize, trunc_normal_init


class DINOHead(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3,
                 norm_last_layer: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm_last_layer = norm_last_layer
        n = max(1, nlayers)
        dims = [in_dim] + [hidden_dim] * (n - 1) + [bottleneck_dim]
        layers = []
        for i in range(n):
            if i:
                layers.append(nn.GELU(approximate="tanh"))
            layers.append(nn.Linear(dims[i], dims[i + 1]))
        self.mlp = nn.Sequential(*layers)
        self.last_layer = nn.Linear(bottleneck_dim, out_dim, bias=False)

    def init_weights(self, generator: torch.Generator) -> None:
        """Truncated-normal(0.02) weights, zero biases, drawn in order."""
        with torch.no_grad():
            for m in list(self.mlp) + [self.last_layer]:
                if isinstance(m, nn.Linear):
                    trunc_normal_init(m.weight, generator)
                    if m.bias is not None:  # the prototype layer has none
                        m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[..., in_dim] -> fp32 logits [..., out_dim]."""
        for m in self.mlp:
            if isinstance(m, nn.Linear):
                x = dense(x, m.weight, m.bias, self.dtype)
            else:
                x = F.gelu(x, approximate="tanh")
        x = l2_normalize(x.float()).to(self.dtype)
        w = self.last_layer.weight.float()
        if self.norm_last_layer:
            w = l2_normalize(w, dim=-1)
        return torch.matmul(x.float(), w.t())
