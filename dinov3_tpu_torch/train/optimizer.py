"""Per-submodel gradient clip, scheduled AdamW and the teacher EMA, in one
update over the student's parameters (``dinov3_tpu/train/fused_update.py``
``update_leaf_math`` and ``ema_leaf``, and ``train/optimizer.py``).

Per parameter, with the step's lr, last-layer lr and weight decay taken
from the schedules at the update count, and lm, wm its multipliers:
    g   <- g * min(1, clip / ||grads of its submodel||)
    mu  <- b1 mu + (1 - b1) g,  nu <- b2 nu + (1 - b2) g^2
    d   <- (mu / bc1) / (sqrt(nu / bc2) + eps) + wd * wm * p
    p   <- p - lr * lm * d      (the last-layer lr for the prototypes)
    t   <- m t + (1 - m) p      (the teacher, from the updated student)
with bc = 1 - b ** count. Under distillation (``ema=False``) the teacher
is frozen and the last line is skipped. The arithmetic runs as ``torch._foreach_*``
passes over all parameters at once. The parameters, moments and teacher
are updated in place; the update direction and the Adam denominator are
temporaries of one parameter set each.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dinov3_tpu_torch.train.param_groups import build_multipliers


@dataclasses.dataclass
class AdamWState:
    mu: list
    nu: list
    count: int = 0  # updates taken: the schedule index and Adam's count


def per_submodel_norms(names, grads) -> dict:
    """fp32 global gradient norm per top-level submodel (backbone,
    dino_head, ibot_head), as 0-d tensors."""
    sums: dict = {}
    for name, g in zip(names, grads):
        key = name.split(".", 1)[0]
        sq = g.float().square().sum()
        sums[key] = sq if key not in sums else sums[key] + sq
    return {k: torch.sqrt(v) for k, v in sums.items()}


def ema_(teacher_params, student_params, momentum: float) -> None:
    """teacher <- m * teacher + (1 - m) * student, in place, fp32."""
    torch._foreach_mul_(teacher_params, momentum)
    torch._foreach_add_(teacher_params, student_params, alpha=1.0 - momentum)


class ScheduledAdamW:
    """The update of one student (an ``nn.Module`` whose top-level children
    are the submodels) into its teacher, with the schedules' lr and wd;
    ``ema=False`` leaves the teacher as it is (a frozen distillation
    teacher)."""

    def __init__(self, student: torch.nn.Module, schedules, *,
                 layerwise_decay: float = 1.0, patch_embed_lr_mult: float = 1.0,
                 dino_head_wd_multiplier: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 clip_grad: float | None = 3.0, ema: bool = True):
        named = list(student.named_parameters())
        self.names = [n for n, _ in named]
        mult = build_multipliers(
            self.names, layerwise_decay=layerwise_decay,
            patch_embed_lr_mult=patch_embed_lr_mult,
            dino_head_wd_multiplier=dino_head_wd_multiplier)
        self.lr_mult = [mult[n].lr for n in self.names]
        self.wd_mult = [mult[n].wd for n in self.names]
        self.is_last = [mult[n].is_last_layer for n in self.names]
        self.schedules = schedules
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_grad = clip_grad
        self.ema = ema

    def init_state(self, student: torch.nn.Module) -> AdamWState:
        params = [p for _, p in student.named_parameters()]
        return AdamWState(mu=[torch.zeros_like(p) for p in params],
                          nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, student: torch.nn.Module, teacher: torch.nn.Module,
               state: AdamWState, momentum: float) -> dict:
        """Apply one update from the student's ``.grad``s (a parameter
        without one counts as a zero gradient); returns the per-submodel
        pre-clip gradient norms."""
        params = [p for _, p in student.named_parameters()]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norms = per_submodel_norms(self.names, grads)
        if self.clip_grad is not None and self.clip_grad > 0:
            for key, norm in norms.items():
                sub = [g for n, g in zip(self.names, grads)
                       if n.split(".", 1)[0] == key]
                scale = torch.clamp(self.clip_grad / torch.clamp(norm, min=1e-12),
                                    max=1.0)
                torch._foreach_mul_(sub, scale)
        s = self.schedules
        i = min(state.count, s.total_iters - 1)
        lr_t, ll_lr_t, wd_t = (float(np.float32(a[i]))
                               for a in (s.lr, s.last_layer_lr, s.weight_decay))
        state.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(state.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(state.count))
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        direction = torch._foreach_div(state.mu, bc1)
        torch._foreach_div_(direction, denom)
        del denom
        torch._foreach_add_(direction, torch._foreach_mul(
            params, [wd_t * wm for wm in self.wd_mult]))
        torch._foreach_mul_(direction, [
            -(ll_lr_t if last else lr_t) * lm
            for lm, last in zip(self.lr_mult, self.is_last)])
        torch._foreach_add_(params, direction)
        del direction
        if self.ema:
            ema_([p for _, p in teacher.named_parameters()], params, momentum)
        return norms
