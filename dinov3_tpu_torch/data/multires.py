"""Crop-size lists (``dinov3_tpu/data/multires.py``): one data stream per
(global, local) crop-size pair, combined by ratio.

``CombineDataLoader`` draws each batch from stream k with probability
ratio_k, by a host generator seeded with ``train.seed``: deterministic,
and resumable (``split_advance`` replays the choice stream to count the
batches each stream gave in a skipped prefix). The port's step takes any
crop shape, so a list needs nothing else.
"""

from __future__ import annotations

import copy
from typing import Iterator, Sequence

import numpy as np


def multires_subconfigs(cfg):
    """One (sub_cfg, ratio) per (global, local) crop-size pair of the
    ``crops`` lists, or None for scalar sizes (one resolution). Lists that
    name Gram teacher sizes wait with the Gram anchor (ROADMAP M12)."""
    crops = cfg.crops
    g_sizes = crops.global_crops_size
    if not isinstance(g_sizes, (list, tuple)):
        return None
    if crops.get("gram_teacher_crops_size"):
        raise NotImplementedError(
            "crops.gram_teacher_crops_size in a crop-size list: the Gram "
            "anchor waits (ROADMAP M12)")
    l_sizes = crops.local_crops_size
    ratios = crops.get("global_local_crop_pairs_ratios")
    if not isinstance(l_sizes, (list, tuple)) or len(l_sizes) != len(g_sizes):
        raise ValueError("global/local crop size lists must have equal length")
    if not isinstance(ratios, (list, tuple)):
        ratios = [1.0] * len(g_sizes)
    out = []
    for g, l, r in zip(g_sizes, l_sizes, ratios):
        sub = copy.deepcopy(cfg)
        sub.crops.global_crops_size = int(g)
        sub.crops.local_crops_size = int(l)
        sub.crops.gram_teacher_crops_size = None
        out.append((sub, float(r)))
    return out


def split_advance(seed: int, ratios: Sequence[float], n_batches: int) -> np.ndarray:
    """Replay the combiner's choice stream for ``n_batches`` draws: how many
    batches each stream gave (exact resume)."""
    p = np.asarray(ratios, np.float64) / float(sum(ratios))
    if not n_batches:
        return np.zeros(len(ratios), np.int64)
    draws = np.random.default_rng(seed).choice(len(ratios), size=n_batches, p=p)
    return np.bincount(draws, minlength=len(ratios))


class CombineDataLoader:
    """Draws batches from ``loaders`` with probabilities ``ratios``.
    Iterating returns an iterator whose ``close()`` closes every stream
    that has a ``close`` (the pipelines' producer threads)."""

    def __init__(self, loaders: Sequence, ratios: Sequence[float], seed: int = 0):
        if len(loaders) != len(ratios):
            raise ValueError("need one ratio per loader")
        total = float(sum(ratios))
        if total <= 0:
            raise ValueError("ratios must sum to a positive value")
        self.loaders = list(loaders)
        self.ratios = [float(r) / total for r in ratios]
        self.seed = seed
        self._drawn = 0

    def advance(self, n: int) -> None:
        """Skip n draws (resume): keeps the choice stream aligned."""
        self._drawn += n

    def __iter__(self) -> "_Combined":
        return _Combined(self)


class _Combined:
    def __init__(self, combiner: CombineDataLoader):
        self._iters = [iter(ld) for ld in combiner.loaders]
        self._p = combiner.ratios
        self._rng = np.random.default_rng(combiner.seed)
        if combiner._drawn:
            self._rng.choice(len(self._iters), size=combiner._drawn, p=self._p)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        k = int(self._rng.choice(len(self._iters), p=self._p))
        return next(self._iters[k])

    def close(self) -> None:
        for it in self._iters:
            close = getattr(it, "close", None)
            if close is not None:
                close()
