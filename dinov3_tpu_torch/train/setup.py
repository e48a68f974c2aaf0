"""Training setup on one device (``dinov3_tpu/train/setup.py``
``build_train_setup``): the meta-architecture with seeded weights, the
schedules, the optimizer state and the step."""

from __future__ import annotations

import dataclasses
from typing import Callable

from dinov3_tpu_torch.ops.common import resolve_device
from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
from dinov3_tpu_torch.train.schedules import Schedules, build_schedules
from dinov3_tpu_torch.train.ssl_meta_arch import SSLMetaArch
from dinov3_tpu_torch.train.train_step import (
    TrainState,
    make_train_launch,
    make_train_step,
    packed_layout,
    split_microbatches,
)


@dataclasses.dataclass
class TrainSetup:
    cfg: object
    meta: SSLMetaArch
    schedules: Schedules
    optimizer: ScheduledAdamW
    state: TrainState
    step_fn: Callable  # step_fn(state, batch, scalars, plan=None) -> (state, metrics)
    launch_fn: Callable  # the same step returning (state, StepMetrics), unread

    def scalars(self, iteration: int) -> dict:
        s = self.schedules.at(iteration)
        return {"teacher_temp": float(s["teacher_temp"]),
                "momentum": float(s["momentum"])}


def build_train_setup(cfg, example_batch: dict, *, device="cuda",
                      seed: int = 0, n_blocks: int | None = None) -> TrainSetup:
    """Everything one step needs, on ``device`` (``"cuda"`` without a
    card raises; ``device="cpu"`` runs the kernels' plain versions). The
    weights are drawn on the CPU from ``seed``, so they do not depend on
    the device; the step's drop-path plans are keyed by (seed,
    iteration). ``example_batch`` is checked against the slice's crop
    geometry (local crops must pack at least 2 to a global row) and
    against ``optim.accum_steps`` (it must divide the image batch; raises
    ``ValueError``). ``n_blocks`` cuts the configured depth (None keeps
    it)."""
    dev = resolve_device(device)
    meta = SSLMetaArch(cfg, seed=seed, n_blocks=n_blocks)
    accum = int(cfg.optim.get("accum_steps", 1) or 1)
    # the packed layout is fixed by the crop sizes and the microbatch
    # split by accum_steps: fail here, not mid-step
    layout = packed_layout(cfg, split_microbatches(example_batch, accum)[0])
    if layout.k < 2:
        raise ValueError(
            f"crop packing needs k >= 2 local sequences per global row "
            f"(N_g={layout.seq_global}, N_l={layout.seq_local})")
    meta = meta.to(dev)
    schedules = build_schedules(cfg)
    o = cfg.optim
    optimizer = ScheduledAdamW(
        meta.student, schedules, layerwise_decay=o.layerwise_decay,
        patch_embed_lr_mult=o.patch_embed_lr_mult,
        dino_head_wd_multiplier=o.dino_head_wd_multiplier,
        b1=o.adamw_beta1, b2=o.adamw_beta2, clip_grad=o.clip_grad)
    state = TrainState(meta=meta, opt_state=optimizer.init_state(meta.student))
    return TrainSetup(cfg=cfg, meta=meta, schedules=schedules,
                      optimizer=optimizer, state=state,
                      step_fn=make_train_step(optimizer, seed=seed, accum_steps=accum),
                      launch_fn=make_train_launch(optimizer, seed=seed,
                                                  accum_steps=accum))
