"""Warm starts from earlier runs' checkpoints (``dinov3_tpu/train/pretrained.py``).

- ``student.pretrained_weights``: a checkpoint directory whose **student**
  branch initializes this run's student;
- ``student.resume_from_teacher_chkpt``: a checkpoint directory whose
  **teacher** branch (the EMA weights DINOv3 evaluates) initializes this
  run's student.

The two keys together raise. Both restores are partial, by name and
shape: a leaf the checkpoint lacks, or holds at another shape (head
prototype counts differ across recipes), keeps its value. Then the
teacher mirrors the warm-started student wherever name and shape match
(a momentum teacher starts as the student; a distillation teacher of
another architecture keeps its own weights where they differ), and so
does the Gram branch's backbone. Checkpoints of this package and the JAX
package's local-npz ones are read (``checkpoint.params_state_dicts``).
"""

from __future__ import annotations

import logging

import torch

from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def _matching(saved: dict, target: dict) -> list:
    """Names of ``target`` that ``saved`` holds at the same shape."""
    return [k for k, v in target.items()
            if k in saved and tuple(saved[k].shape) == tuple(v.shape)]


@torch.no_grad()
def _restore_branch(path: str, branch: str, target: torch.nn.Module,
                    step: int | None = None) -> int:
    """``target`` <- the checkpoint's ``branch`` where names and shapes
    match, in place; returns the step read (``step``, None: the latest).
    Raises ``KeyError`` without the branch, ``ValueError`` when no leaf
    matches."""
    from dinov3_tpu_torch.checkpoint import params_state_dicts

    step, sds = params_state_dicts(path, step, (branch,))
    if branch not in sds:
        raise KeyError(f"checkpoint at {path} has no params[{branch!r}]")
    dst = target.state_dict()
    names = _matching(sds[branch], dst)
    if not names:
        raise ValueError(f"no leaf of params[{branch!r}] in {path} matches the "
                         "target shapes")
    for k in names:
        dst[k].copy_(sds[branch][k])
    logger.info("loaded %r branch from %s step %d (%d/%d leaves matched)",
                branch, path, step, len(names), len(dst))
    return step


@torch.no_grad()
def _mirror_into(dst: torch.nn.Module, src: dict) -> None:
    """``dst``'s leaves <- ``src``'s wherever name and shape match."""
    target = dst.state_dict()
    for k in _matching(src, target):
        target[k].copy_(src[k])


def load_pretrained_weights(cfg, state):
    """Apply the student warm-start keys to a freshly initialized state,
    in place (the module docstring)."""
    from_teacher = cfg.student.get("resume_from_teacher_chkpt") or ""
    from_student = cfg.student.get("pretrained_weights") or ""
    if not from_teacher and not from_student:
        return state
    if from_teacher and from_student:
        raise ValueError(
            "student.pretrained_weights and student.resume_from_teacher_chkpt "
            f"are mutually exclusive (got {from_student!r} and {from_teacher!r})")
    meta = state.meta
    if from_teacher:  # the checkpoint's teacher -> this run's student
        _restore_branch(from_teacher, "teacher", meta.student)
    else:
        _restore_branch(from_student, "student", meta.student)
    student = meta.student.state_dict()
    _mirror_into(meta.teacher, student)
    if meta.gram is not None:
        _mirror_into(meta.gram, {k: v for k, v in student.items() if k.startswith("backbone.")})
    return state
