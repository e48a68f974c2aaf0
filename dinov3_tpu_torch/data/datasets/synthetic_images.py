"""Synthetic PIL-image dataset (``dinov3_tpu/data/datasets/
synthetic_images.py``): the whole host pipeline (image -> transform ->
collate) with no disk, selected as ``Synthetic:size=10000``.

Image ``index`` holds uint8 noise from ``default_rng((seed, index, 0))``
and its class from ``default_rng((seed, index, 1))``, where the seed is
``4 * seed`` plus the split's offset (TRAIN 0, VAL 1, TEST 2), so the
splits draw from distinct index universes."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from PIL import Image

from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset


class SyntheticImages(ExtendedVisionDataset):
    def __init__(
        self,
        *,
        size: int = 10_000,
        image_size: int = 256,
        n_classes: int = 1000,
        split: str = "TRAIN",
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
        seed: int = 0,
    ):
        super().__init__(transform, target_transform, seed)
        seed_offset = {"TRAIN": 0, "VAL": 1, "TEST": 2}.get(str(split).upper(), 0)
        self.seed = seed * 4 + seed_offset
        self.size = int(size)
        self.image_size = int(image_size)
        self.n_classes = int(n_classes)

    def __getitem__(self, index: int):
        rng = np.random.default_rng((self.seed, index, 0))
        arr = rng.integers(0, 256, (self.image_size, self.image_size, 3),
                           dtype=np.uint8)
        image = Image.fromarray(arr)
        target = self.get_target(index)
        if self.transform is not None:
            image = self.transform(self.sample_rng(index), image)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return image, target

    def get_target(self, index: int) -> int:
        rng = np.random.default_rng((self.seed, index, 1))
        return int(rng.integers(0, self.n_classes))

    def get_targets(self) -> np.ndarray:
        return np.asarray([self.get_target(i) for i in range(self.size)], np.int64)

    def __len__(self) -> int:
        return self.size
