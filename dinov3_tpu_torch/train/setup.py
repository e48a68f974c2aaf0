"""Training setup on one device (``dinov3_tpu/train/setup.py``
``build_train_setup``): the meta-architecture with seeded weights, the
schedules, the optimizer state, the step, the telemetry plan (the device
metrics ring, ``telemetry.async_metrics``) and, under an fp8 / int8
``train.low_precision.arm``, the amax rings with the set-up drift probe."""

from __future__ import annotations

import dataclasses
from typing import Callable

from dinov3_tpu_torch.configs.config import lowp_cfg, warn_lowp_divergence
from dinov3_tpu_torch.ops.common import resolve_device
from dinov3_tpu_torch.ops.lowp import lowp_drift_probe, lowp_history_init
from dinov3_tpu_torch.telemetry import RingReader, make_ring, telemetry_wished
from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
from dinov3_tpu_torch.train.schedules import Schedules, build_schedules
from dinov3_tpu_torch.train.ssl_meta_arch import SSLMetaArch
from dinov3_tpu_torch.train.train_step import (
    TrainState,
    make_telemetry_launch,
    make_train_launch,
    make_train_step,
    metric_names,
    split_microbatches,
)


@dataclasses.dataclass
class TelemetryPlan:
    """The metrics ring's launch and layout (``telemetry.flush_every``
    rows of ``metric_names``)."""

    launch_fn: Callable  # launch(state, ring, batch, scalars, plan=None) -> (state, ring)
    metric_names: list
    ring_len: int
    device: object

    def init_ring(self):
        return make_ring(len(self.metric_names), self.ring_len, self.device)

    def reader(self, start_iteration: int = 0) -> RingReader:
        return RingReader(self.metric_names, self.ring_len, start_iteration)


@dataclasses.dataclass
class TrainSetup:
    cfg: object
    meta: SSLMetaArch
    schedules: Schedules
    optimizer: ScheduledAdamW
    state: TrainState
    step_fn: Callable  # step_fn(state, batch, scalars, plan=None) -> (state, metrics)
    launch_fn: Callable  # the same step returning (state, StepMetrics), unread
    # the metrics ring; None: telemetry.async_metrics=false (the oracle)
    telemetry: TelemetryPlan | None = None
    # train.low_precision, resolved, and the set-up drift probe
    # ({site: relative Frobenius error, "max"}; None on the bf16 arm)
    lowp: dict | None = None
    lowp_drift: dict | None = None

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
    iteration). ``example_batch`` is checked against ``optim.accum_steps``
    (it must divide the image batch; raises ``ValueError``). ``n_blocks``
    cuts the configured depth (None keeps it)."""
    dev = resolve_device(device)
    meta = SSLMetaArch(cfg, seed=seed, n_blocks=n_blocks)
    accum = int(cfg.optim.get("accum_steps", 1) or 1)
    # the microbatch split is fixed by accum_steps: fail here, not
    # mid-step (a batch whose local crops do not pack runs two passes)
    split_microbatches(example_batch, accum)
    meta = meta.to(dev)
    schedules = build_schedules(cfg)
    o = cfg.optim
    optimizer = ScheduledAdamW(
        meta.student, schedules, layerwise_decay=o.layerwise_decay,
        patch_embed_lr_mult=o.patch_embed_lr_mult,
        dino_head_wd_multiplier=o.dino_head_wd_multiplier,
        b1=o.adamw_beta1, b2=o.adamw_beta2, clip_grad=o.clip_grad)
    state = TrainState(meta=meta, opt_state=optimizer.init_state(meta.student))
    lp = lowp_cfg(cfg)
    drift = None
    if lp["arm"] != "bf16":
        # rings seeded with the current masters' amax in every slot
        state.lowp = {k: lowp_history_init(getattr(meta, k)["backbone"],
                                           lp["amax_history_len"])
                      for k in ("student", "teacher")}
        drift = lowp_drift_probe(meta.student["backbone"], state.lowp["student"],
                                 lp["arm"], lp["scale_margin"])
        warn_lowp_divergence(drift["max"], tol=lp["divergence_tol"],
                             axis=f"lowp train matmuls ({lp['arm']})")
    launch = make_train_launch(optimizer, seed=seed, accum_steps=accum, lowp=lp)
    plan = None
    if telemetry_wished(cfg):
        names = metric_names(meta)
        plan = TelemetryPlan(
            launch_fn=make_telemetry_launch(launch, names), metric_names=names,
            ring_len=int((cfg.get("telemetry") or {}).get("flush_every", 50)),
            device=dev)
    return TrainSetup(cfg=cfg, meta=meta, schedules=schedules,
                      optimizer=optimizer, state=state,
                      step_fn=make_train_step(optimizer, seed=seed, accum_steps=accum,
                                              lowp=lp),
                      launch_fn=launch, telemetry=plan, lowp=lp,
                      lowp_drift=drift)
