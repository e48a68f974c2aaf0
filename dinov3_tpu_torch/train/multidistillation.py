"""Multi-distillation: several students against one frozen teacher, each
on its own span of ranks (``dinov3_tpu/train/multidistillation.py``).

``setup_multidistillation`` resolves this rank's student from the spec
(``multidistillation.students``: name, ``config_path``, ``ranks_range``
[first, last)); the spans must partition the world. The port trains on
one card, so the trainer routes at world size 1 (a spec covering [0, 1));
students co-hosted in several processes wait for ROADMAP M7.

``shared_teacher_server`` is the process-level registry of
``TeacherServer``s: every student of this process distilling from the
same teacher (config path, weights or checkpoint, global crop size) gets
the same server, so k students pay one teacher forward per image.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

from dinov3_tpu_torch.configs import ConfigNode, apply_dot_overrides, load_config
from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def enumerate_subgroup_ranks(spans) -> tuple[tuple[int, ...], ...]:
    """[[first, last_exclusive], ...] -> the member ranks of each span;
    an empty span raises ``ValueError``."""
    groups = []
    for first, last in spans:
        if first >= last:
            raise ValueError(f"empty rank span [{first}, {last})")
        groups.append(tuple(range(first, last)))
    return tuple(groups)


@dataclasses.dataclass
class MultiDistillationAssignment:
    name: str
    index: int                  # which student group
    cfg: ConfigNode             # the student's merged config
    group_ranks: tuple[int, ...]
    group_rank: int             # this process's rank within the group
    output_dir: str


def setup_multidistillation(cfg: ConfigNode, rank: int, world_size: int,
                            base_output_dir: str,
                            extra_overrides: list[str] | None = None,
                            ) -> MultiDistillationAssignment:
    """This rank's student: the spans validated, the span holding ``rank``
    found, the student's config merged (default <- its yaml, with the base
    run's ``distillation``, ``multidistillation`` and ``teacher`` blocks,
    <- ``extra_overrides``), the global batch split evenly over the ranks,
    and its own output directory ``<base_output_dir>/<name>``."""
    md = cfg.multidistillation
    if not md.enabled:
        raise ValueError("multidistillation.enabled is false")
    students = list(md.students)
    if not students:
        raise ValueError("multidistillation.students is empty")
    spans = [tuple(s["ranks_range"]) for s in students]
    groups = enumerate_subgroup_ranks(spans)
    covered = [r for g in groups for r in g]
    if sorted(covered) != list(range(world_size)):
        raise ValueError(f"rank spans {spans} must partition [0, {world_size})")
    mine = next((i for i, g in enumerate(groups) if rank in g), None)
    if mine is None:
        raise ValueError(f"rank {rank} not covered by any student span")
    student = students[mine]
    name = student["name"]
    output_dir = os.path.join(base_output_dir, name)
    global_bs = int(md.get("global_batch_size", 0) or 0)
    overrides = list(extra_overrides or []) + [f"train.output_dir={output_dir}"]
    if global_bs:
        if global_bs % world_size:
            raise ValueError(f"multidistillation.global_batch_size={global_bs} not "
                             f"divisible by {world_size} hosts")
        overrides.append(f"train.batch_size_per_device={global_bs // world_size}")
    student_cfg = load_config(student["config_path"])
    # the base run's blocks win over the student recipe's
    for key in ("distillation", "multidistillation", "teacher"):
        if key in cfg:
            student_cfg[key] = cfg[key]
    apply_dot_overrides(student_cfg, overrides)
    logger.info("multidistillation: rank %d -> student %r (group %d, ranks %s)",
                rank, name, mine, groups[mine])
    return MultiDistillationAssignment(
        name=name, index=mine, cfg=student_cfg, group_ranks=groups[mine],
        group_rank=groups[mine].index(rank), output_dir=output_dir)


# (teacher config path, weights source, global crop size) -> the servers
# built under that key; a state's teacher is matched by its serving
# weights (``TeacherServer.serves``), compared on the card rather than
# hashed through the host
_SHARED_TEACHERS: dict = {}


def _teacher_key(cfg, ckpt_dir) -> tuple:
    src = "state" if ckpt_dir is None else str(ckpt_dir)
    return (str(cfg.distillation.full_cfg_path), src, int(cfg.crops.global_crops_size))


def shared_teacher_server(cfg, teacher_params: dict | None = None,
                          ckpt_dir: str | None = None, warn: bool = True,
                          device="cuda"):
    """The process-level ``TeacherServer`` of this teacher, built once and
    then shared: two students of the same teacher config, the same weights
    (``teacher_params``, the backbone's ``state_dict``; or the same
    ``ckpt_dir``) and the same global crop size get the same server;
    another teacher, other weights or another crop size another one."""
    from dinov3_tpu_torch.train.distillation import TeacherServer

    servers = _SHARED_TEACHERS.setdefault(_teacher_key(cfg, ckpt_dir), [])
    for server in servers:
        if ckpt_dir is not None or server.serves(teacher_params):
            logger.info("distillation: reusing the shared teacher server "
                        "(fingerprint %s)", server.fingerprint)
            return server
    t0 = time.perf_counter()
    server = TeacherServer(cfg, teacher_params=teacher_params, ckpt_dir=ckpt_dir,
                           warn=warn, device=device)
    servers.append(server)
    logger.info("distillation: built the shared teacher server (fingerprint %s) "
                "in %.1f s", server.fingerprint, time.perf_counter() - t0)
    return server
