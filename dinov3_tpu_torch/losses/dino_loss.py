"""DINO CLS-token loss (``dinov3_tpu/losses/dino_loss.py``): the
softmax-centering targets and their EMA center, the materialized pair
cross-entropy and its normalization."""

from __future__ import annotations

import torch


def softmax_center_teacher(teacher_logits: torch.Tensor, center: torch.Tensor,
                           teacher_temp: float,
                           storage_dtype: torch.dtype | None = None) -> torch.Tensor:
    """softmax((logits - center) / teacher_temp) over the last axis, in
    fp32 (the fp32 center promotes the logits); ``storage_dtype`` types
    only the returned [*, K] buffer."""
    p = torch.softmax((teacher_logits - center) / teacher_temp, dim=-1)
    return p if storage_dtype is None else p.to(storage_dtype)


def update_center(center: torch.Tensor, teacher_logits: torch.Tensor,
                  momentum: float = 0.9) -> torch.Tensor:
    """EMA of the batch-mean logits, accumulated in fp32 whatever the
    logits' dtype (the center is fp32 state)."""
    batch_center = teacher_logits.mean(dim=0, keepdim=True, dtype=torch.float32)
    return center * momentum + batch_center * (1.0 - momentum)


def dino_pair_ce(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                 student_temp: float = 0.1) -> torch.Tensor:
    """[S, B, K] student logits x [T, B, K] teacher probs -> [S, T] CE,
    summed over the batch. Uses <q, log p> = <q, x> - sum_k(q) * lse(x),
    so no [S, B, K] log-softmax is materialized; fp32 accumulation
    whatever the probs' storage dtype."""
    x = (student_logits / torch.tensor(student_temp, dtype=student_logits.dtype)).float()
    q = teacher_probs.float()
    lse = torch.logsumexp(x, dim=-1)                       # [S, B]
    qsum = q.sum(dim=-1)                                   # [T, B]
    dot = torch.einsum("sbk,tbk->st", x, q)
    corr = torch.einsum("sb,tb->st", lse, qsum)
    return corr - dot


def pair_ce_to_loss(pair_ce: torch.Tensor, batch_size: int,
                    ignore_diagonal: bool = False) -> torch.Tensor:
    """[S, T] pair CE -> scalar loss with the reference normalization;
    ``ignore_diagonal`` drops the same-crop pairs. Shared by the
    materialized and streaming paths."""
    S, T = pair_ce.shape
    B = batch_size
    if ignore_diagonal:
        M = min(S, T)
        eye = torch.eye(S, T, dtype=pair_ce.dtype, device=pair_ce.device)
        return (pair_ce * (1.0 - eye)).sum() / (B * S * T - B * M)
    return pair_ce.sum() / (B * S * T)
