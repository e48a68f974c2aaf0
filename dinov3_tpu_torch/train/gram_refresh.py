"""The Gram teacher's refresh and load (``dinov3_tpu/train/gram_refresh.py``).

The frozen Gram backbone is re-anchored to the EMA teacher's backbone
first after iteration ``gram.it_first_update``, then every
``gram.update_frequency`` iterations, at most ``gram.max_updates``
times; a resumed run rebuilds the count from its start iteration. The
refresh is an on-device copy. ``gram.ckpt`` names a checkpoint directory
(this package's, or the JAX package's local-npz one) whose EMA teacher's
backbone initializes the Gram backbone of a fresh run, at step
``gram.it_load_ema_teacher`` (-1: the latest); the leaves the
checkpoint lacks, or holds at another shape, keep their values, as the
reference's ``_restore_branch`` does.
"""

from __future__ import annotations

import logging
import math

import torch

from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def _refreshes(cfg) -> bool:
    g = cfg.gram
    return bool(g.use_loss and g.rep_update and not g.ema_teacher)


def gram_updates_before(cfg, start_iter: int) -> int:
    """How many refreshes happened before ``start_iter`` (resume)."""
    g = cfg.gram
    if not _refreshes(cfg) or start_iter <= 0 or start_iter < g.it_first_update:
        return 0
    n = math.ceil((start_iter + 1 - g.it_first_update) / g.update_frequency)
    if g.max_updates is not None:
        n = min(n, g.max_updates)
    return n


def should_refresh_gram(cfg, iteration: int, n_done: int) -> bool:
    """After finishing ``iteration`` (0-based), refresh?"""
    g = cfg.gram
    if not _refreshes(cfg):
        return False
    it1 = iteration + 1
    if it1 < g.it_first_update or it1 % g.update_frequency != 0:
        return False
    return g.max_updates is None or n_done < g.max_updates


@torch.no_grad()
def refresh_gram(state):
    """gram.backbone <- teacher.backbone, copied on the device in place."""
    meta = state.meta
    meta.gram["backbone"].load_state_dict(meta.teacher["backbone"].state_dict())
    logger.info("gram teacher refreshed from EMA teacher")
    return state


@torch.no_grad()
def load_gram_teacher(cfg, state):
    """gram.backbone <- the EMA teacher's backbone of the checkpoint under
    ``gram.ckpt`` (a no-op when unset). Raises ``ValueError`` when the run
    has no Gram branch or no leaf of the checkpoint matches it."""
    path = cfg.gram.get("ckpt")
    if not path:
        return state
    gram = state.meta.gram
    if gram is None:
        raise ValueError(f"gram.ckpt={path} is set but no gram branch exists — "
                         "enable the anchor with gram.use_loss=true")
    from dinov3_tpu_torch.checkpoint import teacher_backbone_state_dict

    step_cfg = cfg.gram.get("it_load_ema_teacher", -1)
    want = None if step_cfg is None or int(step_cfg) < 0 else int(step_cfg)
    step, saved = teacher_backbone_state_dict(path, step=want)
    target = gram["backbone"].state_dict()
    matched = [k for k, v in target.items()
               if k in saved and tuple(saved[k].shape) == tuple(v.shape)]
    if not matched:
        raise ValueError(f"no leaf of the teacher backbone in {path} matches the "
                         "gram backbone's shapes")
    for k in matched:
        target[k].copy_(saved[k])
    logger.info("gram teacher loaded from %s step %d (%d/%d leaves matched)",
                path, step, len(matched), len(target))
    return state
