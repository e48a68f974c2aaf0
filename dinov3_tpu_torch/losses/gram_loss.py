"""Gram anchoring loss (``dinov3_tpu/losses/gram_loss.py``): the mean
squared difference between the student's and the Gram teacher's patch
similarity (Gram) matrices.

``remove_neg`` clips both matrices at 0; ``remove_only_teacher_neg``
clips the teacher's and zeroes the student's entries where both are
negative (the two are exclusive; neither clips nothing). ``token_mask``
restricts the Gram to selected tokens with static shapes: deselected
token rows are zeroed, so their entries vanish for student and teacher
alike, and the mean runs over the selected pairs only; it needs the
token-level Gram (``img_level=False``). The products are plain matmuls
in ``reduce_dtype`` (fp32), as the reference computes them outside any
kernel.
"""

from __future__ import annotations

import torch

from dinov3_tpu_torch.ops.common import l2_normalize


def gram_loss(student_feats: torch.Tensor, teacher_feats: torch.Tensor,
              normalize: bool = True, img_level: bool = True,
              remove_neg: bool = False, remove_only_teacher_neg: bool = False,
              token_mask: torch.Tensor | None = None,
              reduce_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """feats [B, T, D]: per-image [T, T] Grams under ``img_level``, else
    one [B*T, B*T] Gram of the flattened tokens. ``token_mask``: optional
    [B, T] bool of the tokens that enter the Gram."""
    if remove_neg and remove_only_teacher_neg:
        raise ValueError("remove_neg and remove_only_teacher_neg are exclusive")
    if token_mask is not None and img_level:
        raise ValueError("token_mask requires img_level=False")
    s = student_feats.to(reduce_dtype)
    t = teacher_feats.to(reduce_dtype)
    if normalize:  # zero-safe gradient (ops/common.py)
        s, t = l2_normalize(s), l2_normalize(t)
    w = None
    if token_mask is not None:
        w = token_mask.to(reduce_dtype).reshape(-1)          # [B*T]
        s = s * token_mask[..., None].to(s.dtype)
        t = t * token_mask[..., None].to(t.dtype)
    if not img_level:
        s, t = s.reshape(-1, s.shape[-1]), t.reshape(-1, t.shape[-1])
    s_sim = s @ s.transpose(-1, -2)
    t_sim = t @ t.transpose(-1, -2)
    # ``torch.maximum`` halves the gradient at a tie, as ``jnp.maximum``
    # does (a zero token's similarities are exactly 0); ``clamp`` would not
    zero = s_sim.new_zeros(())
    if remove_neg:
        s_sim, t_sim = torch.maximum(s_sim, zero), torch.maximum(t_sim, zero)
    elif remove_only_teacher_neg:
        s_sim = torch.where((s_sim < 0.0) & (t_sim < 0.0), 0.0, s_sim)
        t_sim = torch.maximum(t_sim, zero)
    sq = (s_sim - t_sim) ** 2
    if w is None:
        return sq.mean()
    n = w.sum()
    return sq.sum() / (n * n).clamp(min=1.0)
