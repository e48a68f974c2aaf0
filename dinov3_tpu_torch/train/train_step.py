"""The SSL training step (``dinov3_tpu/train/train_step.py``
``make_train_step``): teacher forward and targets -> student forward
(crop-packed, or two passes) -> losses -> student backward -> per-submodel clip, scheduled
AdamW and the teacher EMA from the updated student (``train/optimizer.py``).
With ``optim.accum_steps`` > 1 the forward and backward run once per
microbatch (``split_microbatches``) before the one update.

PyTorch modules own their parameters, so the state is updated in place
and handed back: ``step(state, batch, scalars, plan=None) -> (state,
metrics)``. The step's metrics cross to the host in one read:
``launch`` returns them as ``StepMetrics``, one device tensor, and a
training loop reads it once it has queued the next batch's copy, so the
host's batch work overlaps the step's device work (the oracle, under
``telemetry.async_metrics=false``). ``make_telemetry_launch`` instead
writes them into the device metrics ring (``telemetry/ring.py``), read
once per ``telemetry.flush_every`` steps.

Under an fp8 / int8 ``train.low_precision.arm`` the step takes this
step's weight scales from the amax rings in ``TrainState.lowp`` before the
forward, binds them to the student's and the teacher's block products
(``ops/lowp.py lowp_bound``) for the forward and backward, and advances
the rings from the updated masters after AdamW and the EMA.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from dinov3_tpu_torch.ops.lowp import lowp_bound, lowp_scales, lowp_state_step
from dinov3_tpu_torch.rng.plan import plan_to_device
from dinov3_tpu_torch.telemetry.ring import write_row
from dinov3_tpu_torch.train.optimizer import AdamWState, ScheduledAdamW
from dinov3_tpu_torch.train.ssl_meta_arch import SSLMetaArch


@dataclasses.dataclass
class TrainState:
    meta: SSLMetaArch      # holds the student, the EMA teacher and the Gram branch
    opt_state: AdamWState
    step: int = 0
    # softmax-centering EMA centers {"dino_center", "ibot_center"} (fp32
    # [1, K]); None: meta.init_state() on the student's device
    center_state: dict | None = None
    # fp8/int8 amax history rings {"student": {weight name: fp32 [H]},
    # "teacher": {...}} (ops/lowp.py); None on the bf16 arm
    lowp: dict | None = None

    def __post_init__(self):
        if self.center_state is None:
            self.center_state = self.meta.init_state(
                next(self.meta.student.parameters()).device)


def put_batch(batch: dict, device) -> dict:
    """Host (numpy) batch -> tensors on ``device``; tensors already there
    pass through. For the card the host arrays are first copied into
    pinned memory, so the copy is queued on the stream and the call
    returns without waiting for it (from pageable memory it would wait)."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


class StepMetrics:
    """One step's loss terms and per-submodel pre-clip gradient norms,
    stacked in one fp32 tensor where the step ran. ``read`` copies them to
    the host in one transfer: {name: float}."""

    def __init__(self, names: list, values: torch.Tensor):
        self.names = names
        self.values = values

    def read(self) -> dict:
        return dict(zip(self.names, self.values.tolist()))


def metric_names(meta: SSLMetaArch) -> list:
    """The step's metrics in ``StepMetrics`` order: the loss terms (with
    the Gram terms under ``gram.use_loss``), then the per-submodel
    pre-clip gradient norms."""
    return meta.loss_names() + [f"grad_norm/{k}" for k in meta.student.keys()]


def split_microbatches(batch: dict, accum_steps: int) -> list[dict]:
    """A crop-major batch -> ``accum_steps`` microbatches, each itself a
    crop-major batch of all crops of B / accum_steps images
    (``dinov3_tpu/train/train_step.py split_microbatches``, unstacked).

    Every leaf is [k * B, ...] with k its crop multiplicity (2 for the
    global-crop leaves, n_local for the local crops), stacked crop by
    crop; each regroups as (k, accum, B / accum, ...) with the accum axis
    moved out front, so microbatch j holds image subset j of every crop.
    numpy arrays or tensors; 0-d leaves pass to every microbatch. Raises
    ``ValueError`` when accum_steps does not divide B."""
    if accum_steps <= 1:
        return [batch]
    b = batch["global_crops"].shape[0] // 2

    def split(x):
        if getattr(x, "ndim", 0) == 0:
            return [x] * accum_steps
        n = x.shape[0]
        if n % b or b % accum_steps:
            raise ValueError(
                f"optim.accum_steps={accum_steps} cannot tile a batch leaf of "
                f"leading dim {n} (image batch {b}); pick accum_steps dividing "
                f"the per-step image batch.")
        k = n // b
        x = x.reshape((k, accum_steps, b // accum_steps) + tuple(x.shape[1:]))
        x = x.movedim(1, 0) if torch.is_tensor(x) else np.moveaxis(x, 1, 0)
        return list(x.reshape((accum_steps, k * (b // accum_steps)) + tuple(x.shape[3:])))

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[j] for k, v in parts.items()} for j in range(accum_steps)]


def make_train_launch(optimizer: ScheduledAdamW, seed: int = 0,
                      accum_steps: int = 1, lowp: dict | None = None):
    """Returns ``launch(state, batch, scalars, plan=None) -> (state,
    StepMetrics)``: the step, queued on the device with no host read.

    ``scalars``: {"teacher_temp", "momentum"} of this iteration
    (``TrainSetup.scalars``). ``plan``: the student's plan (torch or
    numpy arrays, e.g. the JAX plan's; ``SSLMetaArch.get_student_output``),
    or with ``accum_steps`` > 1 a list of one plan per microbatch; when it
    is given the step draws nothing, else it draws its own
    (``SSLMetaArch.draw_plan``) keyed by (seed, iteration), or by (seed,
    iteration, j) for microbatch j.

    ``accum_steps`` > 1 (``optim.accum_steps``): for each microbatch of
    ``split_microbatches``, the teacher, targets, student forward and
    losses, then ``backward()`` of loss_j / accum_steps into ``.grad``;
    after the loop one clip + AdamW + EMA. Loss terms and centers are the
    microbatch means, and every microbatch centers with the same incoming
    state, as in the reference. The reference differentiates one program
    that rematerializes each microbatch (``jax.checkpoint`` inside a
    scan); a backward per microbatch gives the same numbers (up to the
    order of the gradient sums) with live activations one microbatch deep,
    without recomputing.

    ``lowp`` (``configs/config.py lowp_cfg``): an fp8 / int8 arm runs the
    block products quantized while ``state.lowp`` holds rings (module
    docstring); bf16 (or None) is the unchanged step."""
    if accum_steps < 1:
        raise ValueError(f"optim.accum_steps must be >= 1, got {accum_steps}")
    arm = (lowp or {}).get("arm", "bf16")

    def launch(state: TrainState, batch: dict, scalars: dict, plan=None):
        meta = state.meta
        device = next(meta.student.parameters()).device
        micro = split_microbatches(put_batch(batch, device), accum_steps)
        if isinstance(plan, (list, tuple)):
            plans = list(plan)
        elif accum_steps == 1:
            plans = [plan]
        elif plan is None:
            plans = [None] * accum_steps
        else:
            raise ValueError("with optim.accum_steps > 1, pass one plan per microbatch")
        if len(plans) != accum_steps:
            raise ValueError(f"{len(plans)} plans for {accum_steps} microbatches")
        temp = float(scalars["teacher_temp"])
        meta.student.zero_grad(set_to_none=True)
        terms, centers = [], []
        scales = None
        if arm != "bf16" and state.lowp is not None:
            scales = {k: lowp_scales(h, arm, lowp["scale_margin"])
                      for k, h in state.lowp.items()}
        with contextlib.ExitStack() as bound:
            if scales is not None:
                for k in ("student", "teacher"):
                    bound.enter_context(lowp_bound(getattr(meta, k)["backbone"],
                                                   scales[k], arm))
            for j, (mb, p) in enumerate(zip(micro, plans)):
                if p is None:
                    p = meta.draw_plan(seed, state.step, mb,
                                       None if accum_steps == 1 else j)
                total, loss_dict, new_centers = meta(
                    mb, teacher_temp=temp, iteration=state.step,
                    plan=plan_to_device(p, device), state=state.center_state)
                (total if accum_steps == 1 else total / accum_steps).backward()
                terms.append(torch.stack([v.detach().float() for v in loss_dict.values()]))
                centers.append(new_centers)
        norms = optimizer.update(meta.student, meta.teacher, state.opt_state,
                                 float(scalars["momentum"]))
        meta.student.zero_grad(set_to_none=True)
        if scales is not None:  # delayed scaling: the rings see the new masters
            state.lowp = lowp_state_step(state.lowp, meta)
        state.step += 1
        if accum_steps == 1:
            state.center_state = centers[0]
            values = terms[0]
        else:
            state.center_state = {k: torch.stack([c[k] for c in centers]).mean(0)
                                  for k in centers[0]}
            values = torch.stack(terms).mean(0)
        names = list(loss_dict) + [f"grad_norm/{k}" for k in norms]
        values = torch.cat([values, torch.stack([v.float() for v in norms.values()])])
        return state, StepMetrics(names, values)

    return launch


def make_train_step(optimizer: ScheduledAdamW, seed: int = 0, accum_steps: int = 1,
                    lowp: dict | None = None):
    """Returns ``step(state, batch, scalars, plan=None) -> (state,
    metrics)``: ``make_train_launch``'s step followed by its one read;
    ``metrics`` holds the loss terms and the per-submodel pre-clip
    gradient norms as floats."""
    launch = make_train_launch(optimizer, seed, accum_steps, lowp)

    def step(state: TrainState, batch: dict, scalars: dict, plan=None):
        state, metrics = launch(state, batch, scalars, plan)
        return state, metrics.read()

    return step


def make_telemetry_launch(launch, names) -> callable:
    """Wrap ``launch(state, batch, scalars, plan=None) -> (state,
    StepMetrics)`` into ``(state, ring, batch, scalars, plan=None) ->
    (state, ring)``: the step's metrics never leave the device; their row
    is written into the ring at slot ``state.step % K`` and the ring's
    non-finite streak advances from ``total_loss``
    (``telemetry/ring.py write_row``). ``names`` fixes the column order
    the host reader interprets."""
    names = list(names)
    loss_col = names.index("total_loss")

    def telemetry_launch(state: TrainState, ring, batch: dict, scalars: dict,
                         plan=None):
        it = state.step  # the row's stamp: the iteration before the increment
        state, metrics = launch(state, batch, scalars, plan)
        if metrics.names != names:
            raise RuntimeError(f"step metrics {metrics.names} != ring columns {names}")
        return state, write_row(ring, it, metrics.values, loss_col)

    return telemetry_launch
