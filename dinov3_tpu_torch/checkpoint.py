"""Checkpoints of the training state on one card (``dinov3_tpu/checkpoint.py``
``Checkpointer``, its replicated arm and its local-npz backend's
write-then-finalize discipline).

A save of step n writes ``<dir>/tmp.<n>/state.pt`` (``torch.save`` of the
student, the EMA teacher, the Adam moments, the softmax-centering centers,
the fp8/int8 amax rings, the update count and the step, all on the host), flushes and ``fsync``s it, then writes and ``fsync``s a
``FINALIZED`` marker holding the step and the payload's byte count, and
only then renames the directory to ``<dir>/<n>/``. ``latest_step``
announces a digit directory only when its marker parses, names that step
and vouches for the payload's exact size, so a save cut at any point (a
``tmp.*`` directory, a directory without its marker, a truncated payload)
is never resumed from. Retention keeps the newest ``max_to_keep`` steps
plus every ``keep_every``-th. Saving is synchronous.

``restore_jax_local`` reads the JAX package's local-npz checkpoints
(``<dir>/<n>/state.npz`` keyed by the ``jax.tree_util.keystr`` paths of
its ``TrainState``, the centers included) through ``interop/from_jax.py``;
it needs neither JAX nor ``ml_dtypes``. ``teacher_backbone_state_dict``
reads only the EMA teacher's backbone from either kind (evals, serving).
The JAX package's orbax checkpoints are not read: orbax is not a
dependency of the port (ROADMAP M5).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time

import numpy as np
import torch

from dinov3_tpu_torch.logging_utils import LOGGER_NAME
from dinov3_tpu_torch.train.train_step import TrainState

logger = logging.getLogger(LOGGER_NAME)

FORMAT = 2  # 1: no center_state
FINALIZED = "FINALIZED"
PAYLOAD = "state.pt"
JAX_PAYLOAD = "state.npz"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def state_payload(state: TrainState) -> dict:
    """The host copy of everything a resume needs, keyed by the student's
    parameter names (``mu``/``nu`` in ``named_parameters`` order)."""
    meta = state.meta
    names = [n for n, _ in meta.student.named_parameters()]

    def host(sd):
        return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}

    return {
        "format": FORMAT,
        "step": int(state.step),
        "count": int(state.opt_state.count),
        "student": host(meta.student.state_dict()),
        "teacher": host(meta.teacher.state_dict()),
        "mu": host(dict(zip(names, state.opt_state.mu))),
        "nu": host(dict(zip(names, state.opt_state.nu))),
        "center_state": host(state.center_state),
        **({"lowp": {k: host(v) for k, v in state.lowp.items()}}
           if state.lowp is not None else {}),
    }


def _load_lowp(state: TrainState, rings: dict | None) -> None:
    """Checkpoints cross ``train.low_precision`` arms as the reference's
    do: matching rings restore bitwise; a run on a quantized arm restored
    from a checkpoint without (matching) rings reseeds them from the
    restored masters (``lowp_history_init``); rings in the checkpoint of a
    bf16 run are ignored."""
    if state.lowp is None:
        return
    like = state.lowp
    match = rings is not None and set(rings) == set(like) and all(
        set(rings[k]) == set(like[k])
        and all(rings[k][n].shape == t.shape for n, t in like[k].items())
        for k in like)
    if match:
        for k, ring in like.items():
            for n, t in ring.items():
                t.copy_(rings[k][n])
        return
    from dinov3_tpu_torch.ops.lowp import lowp_history_init

    H = next(iter(like["student"].values())).shape[-1]
    state.lowp = {k: lowp_history_init(getattr(state.meta, k)["backbone"], H)
                  for k in like}
    logger.info("restored checkpoint holds no matching lowp rings; reseeded them "
                "from the restored masters")


@torch.no_grad()
def load_payload(state: TrainState, payload: dict) -> TrainState:
    """Copy a payload (``state_payload``'s layout, or the JAX bridge's)
    into ``state``'s modules, moments and centers in place; every name must
    match. A payload without centers (format 1: Sinkhorn-Knopp runs, which
    never read them) keeps the initial ones, except under softmax
    centering, where it raises."""
    meta = state.meta
    meta.student.load_state_dict(payload["student"], strict=True)
    meta.teacher.load_state_dict(payload["teacher"], strict=True)
    names = [n for n, _ in meta.student.named_parameters()]
    for key, dst in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        src = payload[key]
        if set(src) != set(names):
            missing, extra = set(names) - set(src), set(src) - set(names)
            raise KeyError(f"checkpoint {key} does not match the student: "
                           f"missing {sorted(missing)[:5]}, extra {sorted(extra)[:5]}")
        for n, t in zip(names, dst):
            t.copy_(src[n])
    centers = payload.get("center_state")
    if centers is None:
        if meta.centering == "softmax_center":
            raise KeyError("checkpoint holds no softmax-centering centers")
    else:
        if set(centers) != set(state.center_state):
            raise KeyError(f"checkpoint centers {sorted(centers)} != "
                           f"{sorted(state.center_state)}")
        for k, t in state.center_state.items():
            t.copy_(centers[k])
    state.opt_state.count = int(payload["count"])
    state.step = int(payload["step"])
    _load_lowp(state, payload.get("lowp"))
    return state


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 keep_every: int | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        self.keep_every = int(keep_every) if keep_every else None

    # -------- discovery --------

    def _complete(self, step_dir: str, step: int) -> bool:
        """The marker parses, names ``step`` and vouches for the payload's
        byte count."""
        try:
            with open(os.path.join(step_dir, FINALIZED)) as f:
                marker = json.load(f)
            size = os.path.getsize(os.path.join(step_dir, PAYLOAD))
        except (OSError, ValueError):
            return False
        return (isinstance(marker, dict) and marker.get("step") == step
                and marker.get("bytes") == size)

    def steps(self) -> list[int]:
        """Finalized, complete steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(d) for d in os.listdir(self.directory)
            if d.isdigit()
            and self._complete(os.path.join(self.directory, d), int(d)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    # -------- save --------

    def save(self, step: int, state: TrainState) -> dict:
        """Write-then-finalize save of ``state`` as step ``step``; returns
        {"step", "bytes", "seconds"}."""
        t0 = time.perf_counter()
        payload = state_payload(state)
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, PAYLOAD)
        with open(path, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        del payload
        nbytes = os.path.getsize(path)
        # the marker is written only once the payload is on disk, and the
        # directory is announced (renamed) only once the marker is
        with open(os.path.join(tmp, FINALIZED), "w") as f:
            json.dump({"step": int(step), "bytes": nbytes}, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):  # a second save of the same step
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        self._retain()
        info = {"step": int(step), "bytes": nbytes, "seconds": time.perf_counter() - t0}
        logger.info("checkpoint: step %d, %d bytes in %.2f s", step, nbytes,
                    info["seconds"])
        return info

    def _retain(self) -> None:
        """Newest ``max_to_keep`` survive, plus every ``keep_every``-th."""
        steps = self.steps()
        for s in steps[:-self.max_to_keep]:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(os.path.join(self.directory, str(s)), ignore_errors=True)

    # -------- restore --------

    def restore(self, state: TrainState) -> TrainState:
        """Load the latest complete step into ``state`` in place and
        return it."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no finalized checkpoint under {self.directory}")
        path = os.path.join(self.directory, str(step), PAYLOAD)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if payload.get("format") not in (1, FORMAT):
            raise ValueError(f"{path}: not a checkpoint of this package")
        load_payload(state, payload)
        logger.info("restored checkpoint at step %d", step)
        return state

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing is ever in flight."""

    def close(self) -> None:
        self.wait_until_finished()


def jax_local_steps(directory: str) -> list[int]:
    """Finalized steps of a JAX local-npz checkpoint directory (a digit
    directory holding ``state.npz`` and the ``FINALIZED`` marker)."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d) for d in os.listdir(directory)
        if d.isdigit()
        and os.path.exists(os.path.join(directory, d, JAX_PAYLOAD))
        and os.path.exists(os.path.join(directory, d, FINALIZED)))


def teacher_backbone_state_dict(directory: str) -> tuple[int, dict]:
    """(step, the EMA teacher backbone's ``state_dict``) of the latest
    finalized step under ``directory``: a checkpoint of this package
    (``payload["teacher"]``'s ``backbone.*`` tensors, the payload mapped,
    not read whole), else a JAX local-npz one (only the teacher backbone's
    leaves are read). The JAX package's orbax checkpoints are refused
    (ROADMAP M5); a directory with no finalized step raises
    ``FileNotFoundError``."""
    step = Checkpointer(directory).latest_step()
    if step is not None:
        path = os.path.join(directory, str(step), PAYLOAD)
        payload = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
        if payload.get("format") not in (1, FORMAT):
            raise ValueError(f"{path}: not a checkpoint of this package")
        return step, {k[len("backbone."):]: v for k, v in payload["teacher"].items()
                      if k.startswith("backbone.")}
    steps = jax_local_steps(directory)
    if steps:
        from dinov3_tpu_torch.interop.from_jax import (
            TEACHER_BACKBONE,
            keystr_path,
            teacher_backbone_from_jax,
        )

        with np.load(os.path.join(directory, str(steps[-1]), JAX_PAYLOAD)) as z:
            flat = {k: z[k] for k in z.files if keystr_path(k)[:3] == TEACHER_BACKBONE}
        return steps[-1], teacher_backbone_from_jax(flat)
    if os.path.isdir(directory) and any(
            d.isdigit() and os.path.isdir(os.path.join(directory, d, "state"))
            for d in os.listdir(directory)):
        raise NotImplementedError(
            f"{directory} holds orbax checkpoints of the JAX package: only its "
            "local-npz checkpoints are read (ROADMAP M5)")
    raise FileNotFoundError(f"no finalized checkpoint under {directory}")


def restore_jax_local(directory: str, state: TrainState) -> TrainState:
    """Load the latest finalized step of a JAX package local-npz
    checkpoint directory into ``state`` in place: parameters, teacher,
    Adam moments, the update count and the step."""
    from dinov3_tpu_torch.interop.from_jax import train_state_from_jax

    steps = jax_local_steps(directory)
    step = steps[-1] if steps else None
    if step is None:
        raise FileNotFoundError(f"no finalized JAX checkpoint under {directory}")
    with np.load(os.path.join(directory, str(step), JAX_PAYLOAD)) as z:
        flat = {k: z[k] for k in z.files}
    payload = train_state_from_jax(flat)
    load_payload(state, payload)
    logger.info("restored JAX local checkpoint at step %d", step)
    return state
