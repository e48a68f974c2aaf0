"""DINO CLS-token loss with materialized targets
(``dinov3_tpu/losses/dino_loss.py``)."""

from __future__ import annotations

import torch


def dino_pair_ce(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                 student_temp: float = 0.1) -> torch.Tensor:
    """[S, B, K] student logits x [T, B, K] teacher probs -> [S, T] CE,
    summed over the batch. Uses <q, log p> = <q, x> - sum_k(q) * lse(x),
    so no [S, B, K] log-softmax is materialized; fp32 accumulation."""
    x = (student_logits / student_temp).float()
    q = teacher_probs.float()
    lse = torch.logsumexp(x, dim=-1)                       # [S, B]
    qsum = q.sum(dim=-1)                                   # [T, B]
    dot = torch.einsum("sbk,tbk->st", x, q)
    corr = torch.einsum("sb,tb->st", lse, qsum)
    return corr - dot


def pair_ce_to_loss(pair_ce: torch.Tensor, batch_size: int,
                    ignore_diagonal: bool = False) -> torch.Tensor:
    """[S, T] pair CE -> scalar loss with the reference normalization;
    ``ignore_diagonal`` drops the same-crop pairs."""
    S, T = pair_ce.shape
    B = batch_size
    if ignore_diagonal:
        M = min(S, T)
        eye = torch.eye(S, T, dtype=pair_ce.dtype, device=pair_ce.device)
        return (pair_ce * (1.0 - eye)).sum() / (B * S * T - B * M)
    return pair_ce.sum() / (B * S * T)
