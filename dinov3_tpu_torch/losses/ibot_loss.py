"""iBOT masked-token loss on fixed-capacity buffers
(``dinov3_tpu/losses/ibot_loss.py``)."""

from __future__ import annotations

import torch


def ibot_patch_loss_from_parts(dot: torch.Tensor, qsum: torch.Tensor,
                               lse: torch.Tensor, masks_weight: torch.Tensor,
                               n_images: int) -> torch.Tensor:
    """Per-row CE parts -> scalar iBOT loss: dot [M] = <q_m, x_m>, qsum [M]
    = sum_k q_m, lse [M] = logsumexp(x_m); masks_weight [M] is 1 /
    (masked tokens of that image) on valid entries and 0 on padding, so
    the loss is the mean over images of the mean CE over each image's
    masked tokens. Shared by the materialized and streaming
    (``losses/streaming.py``) paths."""
    per_token = dot - qsum * lse
    return -(per_token * masks_weight).sum() / max(n_images, 1)


def ibot_patch_loss_masked(student_logits: torch.Tensor,
                           teacher_probs: torch.Tensor,
                           masks_weight: torch.Tensor, n_images: int,
                           student_temp: float = 0.1) -> torch.Tensor:
    """CE over the padded [M, K] masked-token buffers with materialized
    targets. x stays in its storage dtype: the q * x product is taken in
    the two operands' promoted dtype (bf16 when both are bf16) and only
    the sums accumulate in fp32, as in the reference."""
    x = student_logits / torch.tensor(student_temp, dtype=student_logits.dtype)
    lse = torch.logsumexp(x.float(), dim=-1)                        # [M]
    dot = (teacher_probs * x).sum(dim=-1, dtype=torch.float32)
    qsum = teacher_probs.sum(dim=-1, dtype=torch.float32)
    return ibot_patch_loss_from_parts(dot, qsum, lse, masks_weight, n_images)
