"""The SSL training pipeline (``dinov3_tpu/data/pipeline.py``
``make_train_pipeline``): dataset string (``Folder:``, ``ImageNet:``,
``ImageNet22k:``, ``WebShards:`` or ``Synthetic:``) -> augmented, collated
batches; ``make_multires_train_pipeline`` combines one pipeline per crop
size of a crop-size list (``data/multires.py``). Imports PIL (through the
augmentation)."""

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
    dataset_str = resolve_dataset_str(cfg)
    augment = build_augmentation_from_cfg(cfg)
    dataset = make_dataset(dataset_str, transform=augment, seed=cfg.train.seed)
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


def make_multires_train_pipeline(cfg, global_batch_size: int, rank: int = 0,
                                 world_size: int = 1,
                                 sampler_advance_batches: int = 0) -> Iterator[dict]:
    """``make_train_pipeline``, or with crop-size lists one pipeline per
    (global, local) size pair combined by ``crops.global_local_crop_pairs_ratios``
    (``data/multires.py``). ``sampler_advance_batches`` resumes the combined
    stream exactly: the combiner's choice stream is replayed to count the
    batches each resolution gave in the skipped prefix, and each
    pipeline's sampler advances by that many of its samples."""
    from dinov3_tpu_torch.data.multires import (
        CombineDataLoader,
        multires_subconfigs,
        split_advance,
    )

    local_batch = global_batch_size // max(1, world_size)
    subs = multires_subconfigs(cfg)
    if subs is None:
        return make_train_pipeline(cfg, global_batch_size, rank, world_size,
                                   sampler_advance=sampler_advance_batches * local_batch)
    ratios = [r for _, r in subs]
    counts = split_advance(cfg.train.seed, ratios, sampler_advance_batches)
    loaders = [make_train_pipeline(sub, global_batch_size, rank, world_size,
                                   sampler_advance=int(counts[j]) * local_batch)
               for j, (sub, _) in enumerate(subs)]
    combined = CombineDataLoader(loaders, ratios, seed=cfg.train.seed)
    combined.advance(sampler_advance_batches)
    return iter(combined)
