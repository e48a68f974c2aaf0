"""Sinkhorn-Knopp teacher targets in the log domain
(``dinov3_tpu/losses/sinkhorn.py``).

Padded rows (the fixed-capacity masked-token buffer) are handled by
``row_weights``: zero-weight rows contribute nothing to the column sums
and come back as zero rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEG = -1e30


class SinkhornFactors(NamedTuple):
    """Log-domain factorization of Sinkhorn targets:
    ``q = exp(xs - r - c + log_B)`` (zero on invalid rows).

    xs: [R, K] globally normalized logits in the storage dtype; r: [R, 1]
    fp32 row offsets; c: [1, K] fp32 column offsets; log_B: fp32 scalar
    (log of the effective row count); valid: [R] bool or None (padding
    rows of the fixed-capacity buffer)."""

    xs: torch.Tensor
    r: torch.Tensor
    c: torch.Tensor
    log_B: torch.Tensor
    valid: torch.Tensor | None


def sinkhorn_knopp(logits: torch.Tensor, temperature: float,
                   n_iterations: int = 3,
                   row_weights: torch.Tensor | None = None,
                   storage_dtype: torch.dtype | None = None,
                   return_factors: bool = False):
    """[B, K] teacher logits -> [B, K] assignment probabilities (each
    valid row sums to 1), or with ``return_factors`` the
    ``SinkhornFactors`` that leave q unmaterialized (the streaming CE,
    ``losses/streaming.py``, rebuilds it tile by tile).

    After one global normalization the iterate is kept as ``xs - r - c``
    with row and column offsets, as the reference does, so each
    half-iteration is a reduction over ``xs``. ``storage_dtype`` types the
    stored iterate ``xs`` and the returned q (None: fp32); every
    logsumexp still reduces in fp32."""
    B, K = logits.shape
    xf = (logits / torch.tensor(temperature, dtype=logits.dtype)).float()
    valid = None
    if row_weights is not None:
        valid = row_weights.float() > 0
        log_b = torch.log(valid.float().sum().clamp(min=1.0))
        xf = xf + torch.where(valid, 0.0, NEG)[:, None]
    else:
        log_b = torch.full((), math.log(B), dtype=torch.float32,
                           device=logits.device)
    store = storage_dtype or torch.float32
    xs = (xf - torch.logsumexp(xf.reshape(-1), dim=0)).to(store)
    del xf
    r = torch.zeros(B, 1, dtype=torch.float32, device=logits.device)
    c = torch.zeros(1, K, dtype=torch.float32, device=logits.device)
    log_k = math.log(K)
    for _ in range(n_iterations):
        c = c + torch.logsumexp(xs - r - c, dim=0, keepdim=True) + log_k
        dr = torch.logsumexp(xs - r - c, dim=1, keepdim=True) + log_b
        if valid is not None:
            # padding rows keep their offset, staying near NEG
            dr = torch.where(valid[:, None], dr, 0.0)
        r = r + dr
    if return_factors:
        return SinkhornFactors(xs=xs, r=r, c=c, log_B=log_b, valid=valid)
    q = torch.exp(xs - r - c + log_b).to(store)
    if valid is not None:
        q = torch.where(valid[:, None], q, 0.0)
    return q
