"""Training schedules as precomputed arrays: this package's numpy copy of
``dinov3_tpu/train/schedules.py``.

Every schedule is materialized for the full run length and indexed with
the iteration counter: lr, weight decay, teacher momentum, teacher
temperature and the last-layer lr (zero while the prototypes are frozen).
"""

from __future__ import annotations

import dataclasses

import numpy as np



def cosine_schedule(
    base_value: float,
    final_value: float,
    total_iters: int,
    warmup_iters: int = 0,
    start_warmup_value: float = 0.0,
    freeze_iters: int = 0,
    trunc_extra: float = 0.0,
) -> np.ndarray:
    """freeze -> linear warmup -> (possibly truncated) cosine decay."""
    freeze_iters = min(freeze_iters, total_iters)
    warmup_iters = min(warmup_iters, total_iters - freeze_iters)
    freeze = np.zeros((freeze_iters,))
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters)
    cosine_steps = total_iters - warmup_iters - freeze_iters
    if trunc_extra == 0.0:
        it = np.arange(cosine_steps)
        denom = max(cosine_steps, 1)
        cos = final_value + 0.5 * (base_value - final_value) * (
            1 + np.cos(np.pi * it / denom)
        )
    else:
        # cosine computed over (1+extra) x steps, truncated, then rescaled so
        # the truncated end lands exactly on final_value
        full = int(round((1.0 + trunc_extra) * cosine_steps))
        s = np.cos(np.linspace(0, np.pi, max(full, 2)))[:cosine_steps]
        s = (s + 1.0) / 2.0
        s = (s - s[-1]) / (1.0 - s[-1])
        cos = s * (base_value - final_value) + final_value
    out = np.concatenate([freeze, warmup, cos]).astype(np.float64)
    assert len(out) == total_iters
    return out


def linear_warmup_cosine_decay(
    start: float,
    peak: float,
    end: float,
    warmup_iterations: int,
    total_iterations: int,
    cosine_iterations: int | None = None,
) -> np.ndarray:
    """Schedules-v2 ramp (reference:54-78, endpoint bug fixed)."""
    linear = np.linspace(start, peak, warmup_iterations, endpoint=False)
    if cosine_iterations is None:
        cosine_iterations = total_iterations - warmup_iterations
    cos = (np.cos(np.linspace(0, np.pi, cosine_iterations)) + 1.0) / 2.0
    cos = (peak - end) * cos + end
    remaining = total_iterations - cosine_iterations - warmup_iterations
    assert remaining >= 0, "cosine_iterations exceeds the run length"
    constant = np.full((remaining,), end)
    return np.concatenate([linear, cos, constant]).astype(np.float64)


@dataclasses.dataclass
class Schedules:
    """All per-iteration scalars, each an array of length total_iters."""

    lr: np.ndarray
    weight_decay: np.ndarray
    momentum: np.ndarray
    teacher_temp: np.ndarray
    last_layer_lr: np.ndarray
    total_iters: int

    def at(self, it: int) -> dict:
        i = min(it, self.total_iters - 1)
        return {
            "lr": self.lr[i],
            "weight_decay": self.weight_decay[i],
            "momentum": self.momentum[i],
            "teacher_temp": self.teacher_temp[i],
            "last_layer_lr": self.last_layer_lr[i],
        }


def build_schedules(cfg) -> Schedules:
    if cfg.get("schedules"):
        return _build_schedules_v2(cfg)
    L = cfg.train.OFFICIAL_EPOCH_LENGTH
    total = cfg.optim.epochs * L
    trunc = cfg.optim.schedule_trunc_extra
    lr = cosine_schedule(
        cfg.optim.lr, cfg.optim.min_lr, total,
        warmup_iters=cfg.optim.warmup_epochs * L, trunc_extra=trunc,
    )
    wd = cosine_schedule(
        cfg.optim.weight_decay, cfg.optim.weight_decay_end, total,
        trunc_extra=trunc,
    )
    mom = cosine_schedule(
        cfg.teacher.momentum_teacher, cfg.teacher.final_momentum_teacher,
        total, trunc_extra=trunc,
    )
    # teacher temp: linear warmup then constant for the rest of the run
    # (reference builds only the warmup segment and relies on __getitem__
    # clamping, train.py:…; materialized full-length here)
    warm_T = cfg.teacher.warmup_teacher_temp_epochs * L
    warm_T = min(warm_T, total)
    temp = np.concatenate([
        np.linspace(cfg.teacher.warmup_teacher_temp, cfg.teacher.teacher_temp,
                    warm_T),
        np.full((total - warm_T,), cfg.teacher.teacher_temp),
    ])
    last_layer_lr = lr.copy()
    last_layer_lr[: cfg.optim.freeze_last_layer_epochs * L] = 0.0
    return Schedules(lr, wd, mom, temp, last_layer_lr, total)


def _build_schedules_v2(cfg) -> Schedules:
    L = cfg.train.OFFICIAL_EPOCH_LENGTH
    total = cfg.optim.epochs * L
    s = cfg.schedules

    def ramp(section) -> np.ndarray:
        return linear_warmup_cosine_decay(
            start=section["start"], peak=section["peak"], end=section["end"],
            warmup_iterations=int(section.get("warmup_epochs", 0) * L),
            total_iterations=total,
            cosine_iterations=(
                int(section["cosine_epochs"] * L)
                if "cosine_epochs" in section else None
            ),
        )

    lr = ramp(s["lr"])
    wd = ramp(s["weight_decay"])
    mom = ramp(s["momentum"])
    temp = ramp(s["teacher_temp"])
    last_layer_lr = lr.copy()
    freeze = int(s["lr"].get("freeze_last_layer_epochs", 0) * L)
    last_layer_lr[:freeze] = 0.0
    return Schedules(lr, wd, mom, temp, last_layer_lr, total)
