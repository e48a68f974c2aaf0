"""iBOT masked-token loss on fixed-capacity buffers with materialized
targets (``dinov3_tpu/losses/ibot_loss.py``)."""

from __future__ import annotations

import torch


def ibot_patch_loss_masked(student_logits: torch.Tensor,
                           teacher_probs: torch.Tensor,
                           masks_weight: torch.Tensor, n_images: int,
                           student_temp: float = 0.1) -> torch.Tensor:
    """CE over the padded [M, K] masked-token buffers: masks_weight [M] is
    1 / (masked tokens of that image) on valid entries and 0 on padding,
    so the loss is the mean over images of the mean CE over each image's
    masked tokens. fp32 accumulation."""
    x = (student_logits / student_temp).float()
    q = teacher_probs.float()
    lse = torch.logsumexp(x, dim=-1)                       # [M]
    dot = torch.einsum("mk,mk->m", q, x)
    per_token = dot - q.sum(dim=-1) * lse
    return -(per_token * masks_weight).sum() / max(n_images, 1)
