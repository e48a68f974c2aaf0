"""The SSL training pipeline for image folders (``dinov3_tpu/data/pipeline.py``
``make_train_pipeline``): dataset string -> augmented, collated batches.
Imports PIL (through the augmentation). The multi-resolution pipeline
waits (ROADMAP M4)."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from dinov3_tpu_torch.data.augmentations import build_augmentation_from_cfg
from dinov3_tpu_torch.data.collate import collate_crops
from dinov3_tpu_torch.data.loaders import (
    SamplerType,
    make_data_loader,
    make_dataset,
    resolve_dataset_str,
)


def _collate_for_cfg(cfg, samples_with_targets, rng: np.random.Generator):
    samples = [s for s, _ in samples_with_targets]
    return collate_crops(
        samples, rng,
        patch_size=cfg.student.patch_size,
        global_crops_size=cfg.crops.global_crops_size,
        mask_ratio_min_max=tuple(cfg.ibot.mask_ratio_min_max),
        mask_probability=cfg.ibot.mask_sample_probability,
        mask_random_circular_shift=bool(
            cfg.ibot.get("mask_random_circular_shift", False)),
    )


class _SeededCollate:
    """A fresh mask generator per batch, keyed by (seed, batch ordinal).
    ``start_ordinal`` resumes the mask stream with the sampler, so a run
    resumed at iteration k draws the masks the uninterrupted run drew."""

    def __init__(self, cfg, seed: int, start_ordinal: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.ordinal = start_ordinal

    def __call__(self, samples):
        rng = np.random.default_rng((self.seed, self.ordinal))
        self.ordinal += 1
        return _collate_for_cfg(self.cfg, samples, rng)


def make_train_pipeline(cfg, global_batch_size: int, rank: int = 0,
                        world_size: int = 1, sampler_advance: int = 0) -> Iterator[dict]:
    """Yields collated numpy batch dicts (the meta-arch batch contract),
    ``global_batch_size / world_size`` images each; ``sampler_advance``
    skips that many of this host's samples (resume). Close the returned
    iterator to stop its threads."""
    if global_batch_size % world_size:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{world_size} hosts")
    local_batch = global_batch_size // world_size
    augment = build_augmentation_from_cfg(cfg)
    dataset = make_dataset(resolve_dataset_str(cfg), transform=augment,
                           seed=cfg.train.seed)
    loader = make_data_loader(
        dataset,
        batch_size=local_batch,
        collate_fn=_SeededCollate(cfg, cfg.train.seed + rank,
                                  start_ordinal=sampler_advance // local_batch),
        num_workers=cfg.train.get("num_workers", 8),
        shuffle=True,
        seed=cfg.train.seed,
        rank=rank,
        world_size=world_size,
        sampler_type=SamplerType.SHARDED_INFINITE,
        sampler_advance=sampler_advance,
        drop_last=True,
        prefetch_batches=cfg.data.get("prefetch", 2),
    )
    return iter(loader)
