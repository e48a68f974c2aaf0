"""The SSL training step (``dinov3_tpu/train/train_step.py``
``make_train_step``, ``optim.accum_steps=1``): teacher forward and
targets -> crop-packed student forward -> losses -> student backward ->
per-submodel clip, scheduled AdamW and the teacher EMA from the updated
student (``train/optimizer.py``).

PyTorch modules own their parameters, so the state is updated in place
and handed back: ``step(state, batch, scalars, plan=None) -> (state,
metrics)``.
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
    """Host (numpy) batch -> tensors on ``device``; tensors pass through."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


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


def make_train_step(optimizer: ScheduledAdamW, seed: int = 0):
    """Returns ``step(state, batch, scalars, plan=None) -> (state, metrics)``.

    ``scalars``: {"teacher_temp", "momentum"} of this iteration
    (``TrainSetup.scalars``). ``plan``: the packed pass's drop-path plan
    (torch or numpy arrays, e.g. the JAX plan's ``["packed"]``); when it
    is given the step draws nothing, else it draws its own from a
    generator keyed by (seed, iteration). ``metrics``: the loss terms and
    the per-submodel pre-clip gradient norms, as floats."""

    def step(state: TrainState, batch: dict, scalars: dict, plan=None):
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
        metrics = {k: v.item() for k, v in loss_dict.items()}
        metrics.update({f"grad_norm/{k}": v.item() for k, v in norms.items()})
        return state, metrics

    return step
