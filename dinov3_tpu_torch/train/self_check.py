"""One-batch training self-check (``dinov3_tpu/train/self_check.py``): two
real steps on one batch, then whether every part of the step moved: each
loss finite, each student submodule updated, each teacher submodule moved
through the EMA (under distillation instead: the frozen teacher
unchanged, ``distillation_teacher_frozen``), the frozen Gram branch
unchanged, and the step counter advanced by 2."""

from __future__ import annotations

import logging
import math

import torch

from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def _snapshot(module: torch.nn.Module) -> dict:
    """{child name: [parameter clones]} on the parameters' device."""
    return {name: [p.detach().clone() for p in child.parameters()]
            for name, child in module.named_children()}


def _mean_abs_change(before: list, child: torch.nn.Module) -> float:
    """The mean over parameters of each one's mean absolute change."""
    deltas = [(p.detach() - b).abs().float().mean()
              for b, p in zip(before, child.parameters())]
    return torch.stack(deltas).mean().item() if deltas else 0.0


def run_self_check(setup, batch) -> dict:
    """Returns {check name: ok}; logs a verdict table."""
    meta = setup.meta
    state0 = setup.state
    step0 = state0.step
    student0, teacher0 = _snapshot(meta.student), _snapshot(meta.teacher)
    gram0 = _snapshot(meta.gram) if meta.gram is not None else None
    state1, _ = setup.step_fn(state0, batch, setup.scalars(0))
    state2, metrics2 = setup.step_fn(state1, batch, setup.scalars(1))

    results: dict = {}
    for key, value in metrics2.items():
        if key.endswith("loss"):
            results[f"finite:{key}"] = math.isfinite(value)
    for name, child in meta.student.named_children():
        results[f"student_updates:{name}"] = _mean_abs_change(student0[name], child) > 0.0
    if meta.distillation:  # a frozen pretrained teacher, not an EMA
        results["distillation_teacher_frozen"] = all(
            _mean_abs_change(teacher0[name], child) == 0.0
            for name, child in meta.teacher.named_children())
    else:
        for name, child in meta.teacher.named_children():
            results[f"teacher_ema_moves:{name}"] = _mean_abs_change(teacher0[name], child) > 0.0
    if gram0 is not None:  # the Gram anchor moves only at a refresh
        results["gram_frozen_between_refreshes"] = all(
            _mean_abs_change(gram0[name], child) == 0.0
            for name, child in meta.gram.named_children())
    results["step_counter_advances"] = state2.step == step0 + 2

    width = max(len(k) for k in results)
    logger.info("self-check:\n%s", "\n".join(
        f"  {k:<{width}}  {'ok' if v else 'FAIL'}" for k, v in sorted(results.items())))
    n_fail = sum(not v for v in results.values())
    if n_fail:
        logger.error("self-check: %d/%d checks FAILED", n_fail, len(results))
    else:
        logger.info("self-check: all %d checks passed", len(results))
    return results
