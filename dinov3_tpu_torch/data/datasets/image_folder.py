"""Class-per-subdirectory image folder (``dinov3_tpu/data/datasets/
image_folder.py``): ``root/<class_name>/<image>``, classes sorted
alphabetically. Selected as ``Folder:root=/path``, or by ``data.backend=
folder`` with ``data.root``."""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset

_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif",
               ".tiff"}


class ImageFolder(ExtendedVisionDataset):
    def __init__(
        self,
        *,
        root: str,
        split: str = "TRAIN",  # accepted for dataset-string compatibility
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
        seed: int = 0,
    ):
        super().__init__(transform, target_transform, seed)
        self.root = root
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        if not classes:
            raise FileNotFoundError(f"no class subdirectories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        samples: list[tuple[str, int]] = []
        for cls in classes:
            cdir = os.path.join(root, cls)
            for name in sorted(os.listdir(cdir)):
                if os.path.splitext(name)[1].lower() in _EXTENSIONS:
                    samples.append((os.path.join(cdir, name),
                                    self.class_to_idx[cls]))
        if not samples:
            raise FileNotFoundError(f"no images under {root}")
        self.samples = samples

    def get_image_data(self, index: int) -> bytes:
        path, _ = self.samples[index]
        with open(path, "rb") as f:
            return f.read()

    def get_target(self, index: int) -> int:
        return self.samples[index][1]

    def get_targets(self) -> np.ndarray:
        return np.asarray([t for _, t in self.samples], np.int64)

    def __len__(self) -> int:
        return len(self.samples)
