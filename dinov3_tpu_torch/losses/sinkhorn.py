"""Sinkhorn-Knopp teacher targets in the log domain
(``dinov3_tpu/losses/sinkhorn.py``, the materialized form).

Padded rows (the fixed-capacity masked-token buffer) are handled by
``row_weights``: zero-weight rows contribute nothing to the column sums
and come back as zero rows.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30


def sinkhorn_knopp(logits: torch.Tensor, temperature: float,
                   n_iterations: int = 3,
                   row_weights: torch.Tensor | None = None) -> torch.Tensor:
    """[B, K] teacher logits -> [B, K] fp32 assignment probabilities (each
    valid row sums to 1). After one global normalization the iterate is
    kept as ``xs - r - c`` with row and column offsets, as the reference
    does, so each half-iteration is a reduction over ``xs``."""
    B, K = logits.shape
    xf = (logits / temperature).float()
    valid = None
    if row_weights is not None:
        valid = row_weights.float() > 0
        log_b = torch.log(valid.float().sum().clamp(min=1.0))
        xf = xf + torch.where(valid, 0.0, NEG)[:, None]
    else:
        log_b = torch.full((), math.log(B), dtype=torch.float32,
                           device=logits.device)
    xs = xf - torch.logsumexp(xf.reshape(-1), dim=0)
    del xf
    r = xs.new_zeros(B, 1)
    c = xs.new_zeros(1, K)
    log_k = math.log(K)
    for _ in range(n_iterations):
        c = c + torch.logsumexp(xs - r - c, dim=0, keepdim=True) + log_k
        dr = torch.logsumexp(xs - r - c, dim=1, keepdim=True) + log_b
        if valid is not None:
            # padding rows keep their offset, staying near NEG
            dr = torch.where(valid[:, None], dr, 0.0)
        r = r + dr
    q = torch.exp(xs - r - c + log_b)
    if valid is not None:
        q = torch.where(valid[:, None], q, 0.0)
    return q
