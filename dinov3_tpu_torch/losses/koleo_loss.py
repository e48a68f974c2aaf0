"""KoLeo entropy regularizer (``dinov3_tpu/losses/koleo_loss.py``)."""

from __future__ import annotations

import torch

from dinov3_tpu_torch.ops.common import l2_normalize


def koleo_loss(x: torch.Tensor, topk: int = 1, group_size: int | None = None,
               eps: float = 1e-8) -> torch.Tensor:
    """-mean log distance to the nearest neighbour(s) within contiguous
    groups of ``group_size`` rows (the whole batch when None). x: [B, D];
    eps sits inside the norm's sqrt so coincident points keep a finite
    gradient."""
    B, D = x.shape
    g = group_size or B
    if B % g:
        raise ValueError(f"group_size {g} must divide batch {B}")
    if g < 2:
        raise ValueError("koleo needs at least 2 samples per group")
    xg = l2_normalize(x, eps=eps).reshape(B // g, g, D)
    sims = torch.einsum("gbd,gcd->gbc", xg, xg)
    sims = sims - 2.0 * torch.eye(g, dtype=sims.dtype, device=sims.device)
    nn_idx = torch.topk(sims, min(topk, g - 1), dim=-1).indices   # [G, g, k]
    groups = torch.arange(B // g, device=x.device)[:, None, None]
    diff = xg[:, :, None, :] - xg[groups, nn_idx]                 # [G, g, k, D]
    dists = torch.sqrt((diff * diff).sum(dim=-1) + eps * eps)
    return -torch.log(dists + eps).mean()
