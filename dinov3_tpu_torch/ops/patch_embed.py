"""Patch embedding as an unfold plus one matmul
(``dinov3_tpu/ops/patch_embed.py``).

The weight keeps Meta's conv layout ``proj.weight`` [D, C, p, p]; the
matmul uses it in the [p, p, C] row-major patch order that the JAX
``PatchEmbed`` unfold and the host ``patchify`` (``serve/batcher.py``)
produce, so host-patchified pixels and whole images embed identically.
"""

from __future__ import annotations

import torch
from torch import nn

from dinov3_tpu_torch.ops.common import dense


class _Proj(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int = 16, in_chans: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.dtype = dtype
        self.proj = _Proj(in_chans, embed_dim, patch_size)

    def embed_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """[..., p, p, C] patches -> [..., D]."""
        p, C = self.patch_size, self.in_chans
        lead = patches.shape[:-3]
        flat = patches.reshape(-1, p * p * C)
        # [D, C, p, p] -> [D, p, p, C] -> [D, p*p*C]: the patch's row-major order
        w = self.proj.weight.permute(0, 2, 3, 1).reshape(self.embed_dim, p * p * C)
        return dense(flat, w, self.proj.bias, self.dtype).reshape(
            *lead, self.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] (NHWC) -> [B, H/p * W/p, D]."""
        B, H, W, C = x.shape
        p = self.patch_size
        if H % p or W % p:
            raise ValueError(f"image size {(H, W)} not divisible by patch {p}")
        h, w = H // p, W // p
        x = x.reshape(B, h, p, w, p, C).permute(0, 1, 3, 2, 4, 5)
        return self.embed_patches(x.reshape(B, h * w, p, p, C))
