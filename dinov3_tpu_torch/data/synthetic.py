"""Synthetic random-data backend (``data.backend=synthetic``): this
package's numpy copy of ``dinov3_tpu/data/synthetic.py``'s batch maker and
``SyntheticDataset``, so one seed gives the JAX package's batch bit for
bit. No dataset is needed.
"""

from __future__ import annotations

import numpy as np

from dinov3_tpu_torch.data.masking import sample_ibot_masks


def batch_spec(cfg, batch_size: int) -> dict:
    """Shapes and dtypes of one batch of ``batch_size`` images."""
    B = batch_size
    p = cfg.student.patch_size
    S = cfg.crops.global_crops_size
    s = cfg.crops.local_crops_size
    n_l = cfg.crops.local_crops_number
    T = (S // p) ** 2
    M = max(1, int(T * cfg.ibot.mask_ratio_min_max[1]))
    spec = {
        "global_crops": ((2 * B, S, S, 3), np.float32),
        "local_crops": ((n_l * B, s, s, 3), np.float32),
        "masks": ((2 * B, T), bool),
        "mask_indices": ((2 * B, M), np.int32),
        "mask_weights": ((2 * B, M), np.float32),
        "mask_valid": ((2 * B, M), bool),
    }
    if cfg.crops.gram_teacher_crops_size:
        G = cfg.crops.gram_teacher_crops_size
        spec["gram_teacher_crops"] = ((2 * B, G, G, 3), np.float32)
    return spec


def make_synthetic_batch(cfg, batch_size: int, seed=0) -> dict:
    """Random NHWC crops and iBOT masks of the train-step batch contract:
    global_crops [2B, S, S, 3], local_crops [n_l*B, s, s, 3], masks
    [2B, T] bool, mask_indices [2B, M] int32, mask_weights [2B, M] fp32,
    mask_valid [2B, M] bool (numpy arrays)."""
    rng = np.random.default_rng(seed)
    spec = batch_spec(cfg, batch_size)
    p = cfg.student.patch_size
    S = cfg.crops.global_crops_size
    T = (S // p) ** 2
    M = spec["mask_indices"][0][1]
    batch = {
        "global_crops": rng.standard_normal(
            spec["global_crops"][0], dtype=np.float32),
        "local_crops": rng.standard_normal(
            spec["local_crops"][0], dtype=np.float32),
    }
    masks, idx, w, valid = sample_ibot_masks(
        rng, n_images=2 * batch_size, n_tokens=T, capacity=M,
        grid=(S // p, S // p),
        mask_ratio_min_max=tuple(cfg.ibot.mask_ratio_min_max),
        mask_probability=cfg.ibot.mask_sample_probability,
        random_circular_shift=bool(
            cfg.ibot.get("mask_random_circular_shift", False)),
    )
    batch["masks"] = masks
    batch["mask_indices"] = idx
    batch["mask_weights"] = w
    batch["mask_valid"] = valid
    if "gram_teacher_crops" in spec:
        batch["gram_teacher_crops"] = rng.standard_normal(
            spec["gram_teacher_crops"][0], dtype=np.float32)
    return batch


class SyntheticDataset:
    """Infinite iterator over synthetic batches. Batch i of host ``rank``
    is drawn from the key (seed, rank, i), so hosts draw disjoint streams
    and ``advance`` skips the first n batches (data-stream resume).
    ``train.cache_dataset`` draws a pool of ``CACHE_POOL`` batches once and
    cycles it."""

    CACHE_POOL = 8

    def __init__(self, cfg, batch_size: int, seed: int = 0, rank: int = 0,
                 world_size: int = 1, advance: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.advance = advance
        self.cache = bool(cfg.train.get("cache_dataset", False))

    def _batch(self, i: int) -> dict:
        return make_synthetic_batch(self.cfg, self.batch_size,
                                    seed=(self.seed, self.rank, i))

    def __iter__(self):
        pool = ([self._batch(i) for i in range(self.CACHE_POOL)]
                if self.cache else None)
        i = self.advance
        while True:
            yield pool[i % len(pool)] if pool else self._batch(i)
            i += 1
