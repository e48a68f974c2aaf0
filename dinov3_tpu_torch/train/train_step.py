"""The SSL training step (``dinov3_tpu/train/train_step.py``
``make_train_step``, ``optim.accum_steps=1``): teacher forward and
targets -> crop-packed student forward -> losses -> student backward ->
per-submodel clip, scheduled AdamW and the teacher EMA from the updated
student (``train/optimizer.py``).

PyTorch modules own their parameters, so the state is updated in place
and handed back: ``step(state, batch, scalars, plan=None) -> (state,
metrics)``. The step's metrics cross to the host in one read:
``launch`` returns them as ``StepMetrics``, one device tensor, and a
training loop reads it once it has queued the next batch's copy, so the
host's batch work overlaps the step's device work.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dinov3_tpu_torch.ops.packing import make_packed_layout
from dinov3_tpu_torch.rng.plan import packed_pass_plan, plan_to_device, step_generator
from dinov3_tpu_torch.train.optimizer import AdamWState, ScheduledAdamW
from dinov3_tpu_torch.train.ssl_meta_arch import SSLMetaArch


@dataclasses.dataclass
class TrainState:
    meta: SSLMetaArch      # holds the student and the EMA teacher
    opt_state: AdamWState
    step: int = 0


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


def packed_layout(cfg, batch: dict):
    """The packed student pass's layout for this batch's crop shapes."""
    p = cfg.student.patch_size
    n_prefix = 1 + int(cfg.student.get("n_storage_tokens", 0) or 0)
    g, l = batch["global_crops"], batch["local_crops"]
    return make_packed_layout(
        n_global_rows=g.shape[0], n_local=l.shape[0],
        seq_global=n_prefix + (g.shape[1] // p) * (g.shape[2] // p),
        seq_local=n_prefix + (l.shape[1] // p) * (l.shape[2] // p),
        n_prefix=n_prefix)


def make_train_launch(optimizer: ScheduledAdamW, seed: int = 0):
    """Returns ``launch(state, batch, scalars, plan=None) -> (state,
    StepMetrics)``: the step, queued on the device with no host read.

    ``scalars``: {"teacher_temp", "momentum"} of this iteration
    (``TrainSetup.scalars``). ``plan``: the packed pass's drop-path plan
    (torch or numpy arrays, e.g. the JAX plan's ``["packed"]``); when it
    is given the step draws nothing, else it draws its own from a
    generator keyed by (seed, iteration)."""

    def launch(state: TrainState, batch: dict, scalars: dict, plan=None):
        meta = state.meta
        device = next(meta.student.parameters()).device
        batch = put_batch(batch, device)
        if plan is None:
            plan = packed_pass_plan(
                step_generator(seed, state.step), meta.student["backbone"].n_blocks,
                packed_layout(meta.cfg, batch).rows_total,
                meta.student["backbone"].drop_path_rate,
                meta.student["backbone"].drop_path_mode)
        plan = plan_to_device(plan, device)
        meta.student.zero_grad(set_to_none=True)
        total, loss_dict = meta(batch, teacher_temp=float(scalars["teacher_temp"]),
                                iteration=state.step, plan=plan)
        total.backward()
        norms = optimizer.update(meta.student, meta.teacher, state.opt_state,
                                 float(scalars["momentum"]))
        meta.student.zero_grad(set_to_none=True)
        state.step += 1
        names = list(loss_dict) + [f"grad_norm/{k}" for k in norms]
        values = torch.stack([v.detach().float() for v in loss_dict.values()]
                             + [v.float() for v in norms.values()])
        return state, StepMetrics(names, values)

    return launch


def make_train_step(optimizer: ScheduledAdamW, seed: int = 0):
    """Returns ``step(state, batch, scalars, plan=None) -> (state,
    metrics)``: ``make_train_launch``'s step followed by its one read;
    ``metrics`` holds the loss terms and the per-submodel pre-clip
    gradient norms as floats."""
    launch = make_train_launch(optimizer, seed)

    def step(state: TrainState, batch: dict, scalars: dict, plan=None):
        state, metrics = launch(state, batch, scalars, plan)
        return state, metrics.read()

    return step
