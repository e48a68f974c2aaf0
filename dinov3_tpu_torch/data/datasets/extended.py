"""Base dataset (``dinov3_tpu/data/datasets/extended.py``): raw bytes ->
decoders -> transform. Subclasses provide ``get_image_data(index) ->
bytes`` and ``get_target(index)``; the transform receives a per-sample
``np.random.Generator`` keyed by (seed, index), so every worker thread is
deterministic."""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from dinov3_tpu_torch.data.datasets.decoders import ImageDataDecoder, TargetDecoder


class ExtendedVisionDataset:
    def __init__(
        self,
        transform: Callable | None = None,
        target_transform: Callable | None = None,
        seed: int = 0,
    ) -> None:
        self.transform = transform
        self.target_transform = target_transform
        self.seed = seed

    def get_image_data(self, index: int) -> bytes:
        raise NotImplementedError

    def get_target(self, index: int) -> Any:
        raise NotImplementedError

    def sample_rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, index))

    def __getitem__(self, index: int):
        try:
            image_data = self.get_image_data(index)
            image = ImageDataDecoder(image_data).decode()
        except Exception as e:
            raise RuntimeError(f"cannot read image for sample {index}") from e
        target = TargetDecoder(self.get_target(index)).decode()

        rng = self.sample_rng(index)
        if self.transform is not None:
            image = self.transform(rng, image)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return image, target

    def __len__(self) -> int:
        raise NotImplementedError
