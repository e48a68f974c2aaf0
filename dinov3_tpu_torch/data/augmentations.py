"""DINO multi-crop augmentation on the host, PIL and numpy
(``dinov3_tpu/data/augmentations.py`` ``DataAugmentationDINO``):
- 2 global crops from RandomResizedCrop at max(global, gram) size + hflip;
  crop 1 gets blur p=1, crop 2 blur p=0.1 + solarize p=0.2; both get colour
  jitter (0.4, 0.4, 0.2, 0.1) p=0.8 + grayscale p=0.2 unless
  ``share_color_jitter`` (jitter applied once to the source image);
- ``teacher_no_color_jitter``: separate undistorted teacher globals;
- gram-teacher crops at ``gram_teacher_crops_size`` sharing the global
  crops' geometry, with or without (``gram_teacher_no_distortions``) the
  distortions;
- N local crops, either independent RandomResizedCrops at local scale
  (blur p=0.5) or patch-aligned subcrops of the two global crops with
  recorded pixel offsets (``local_crops_subset_of_global_crops``).

Output arrays are normalized float32 HWC.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image

from dinov3_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ColorJitter,
    gaussian_blur,
    maybe_grayscale,
    maybe_hflip,
    maybe_solarize,
    random_resized_crop,
    to_normalized_array,
)


class DataAugmentationDINO:
    def __init__(
        self,
        global_crops_scale: tuple[float, float],
        local_crops_scale: tuple[float, float],
        local_crops_number: int,
        global_crops_size: int = 224,
        local_crops_size: int = 96,
        gram_teacher_crops_size: int | None = None,
        gram_teacher_no_distortions: bool = False,
        teacher_no_color_jitter: bool = False,
        local_crops_subset_of_global_crops: bool = False,
        patch_size: int = 16,
        share_color_jitter: bool = False,
        horizontal_flips: bool = True,
        mean: Sequence[float] = IMAGENET_MEAN,
        std: Sequence[float] = IMAGENET_STD,
    ):
        self.global_crops_scale = tuple(global_crops_scale)
        self.local_crops_scale = tuple(local_crops_scale)
        self.local_crops_number = local_crops_number
        self.global_crops_size = global_crops_size
        self.local_crops_size = local_crops_size
        self.gram_teacher_crops_size = gram_teacher_crops_size
        self.gram_teacher_no_distortions = gram_teacher_no_distortions
        self.teacher_no_color_jitter = teacher_no_color_jitter
        self.local_crops_subset_of_global_crops = local_crops_subset_of_global_crops
        self.patch_size = patch_size
        self.share_color_jitter = share_color_jitter
        self.horizontal_flips = horizontal_flips
        self.mean = mean
        self.std = std
        self.jitter = ColorJitter(0.4, 0.4, 0.2, 0.1)
        # crop at the max size first, resize down per consumer
        self.global_crop_max_size = max(
            global_crops_size, gram_teacher_crops_size or 0
        )

    # -- pieces ---------------------------------------------------------

    def _geometric_global(self, rng, image: Image.Image) -> Image.Image:
        img = random_resized_crop(
            rng, image, self.global_crop_max_size, scale=self.global_crops_scale
        )
        return maybe_hflip(rng, img, 0.5 if self.horizontal_flips else 0.0)

    def _geometric_local(self, rng, image: Image.Image) -> Image.Image:
        img = random_resized_crop(
            rng, image, self.local_crops_size, scale=self.local_crops_scale
        )
        return maybe_hflip(rng, img, 0.5 if self.horizontal_flips else 0.0)

    def _color(self, rng, img: Image.Image) -> Image.Image:
        if rng.uniform() < 0.8:
            img = self.jitter(rng, img)
        return maybe_grayscale(rng, img, 0.2)

    def _resize(self, img: Image.Image, size: int) -> Image.Image:
        if img.size == (size, size):
            return img
        return img.resize((size, size), Image.BICUBIC)

    def _norm(self, img: Image.Image) -> np.ndarray:
        return to_normalized_array(img, self.mean, self.std)

    # -- full recipe ----------------------------------------------------

    def __call__(self, rng: np.random.Generator, image: Image.Image) -> dict:
        out = {}
        if self.share_color_jitter:
            image = self._color(rng, image)

        gram_size = self.gram_teacher_crops_size
        bases = [self._geometric_global(rng, image) for _ in range(2)]
        globals_transf = []
        for i, base in enumerate(bases):
            img = base
            if not self.gram_teacher_no_distortions:
                # gram crop shares distortions -> stay at max size for now
                pass
            elif gram_size is not None:
                img = self._resize(img, self.global_crops_size)
            if not self.share_color_jitter:
                img = self._color(rng, img)
            if i == 0:
                img = gaussian_blur(rng, img, p=1.0)
            else:
                img = gaussian_blur(rng, img, p=0.1)
                img = maybe_solarize(rng, img, p=0.2)
            globals_transf.append(img)

        global_crops = [
            self._norm(self._resize(img, self.global_crops_size))
            for img in globals_transf
        ]
        out["global_crops"] = global_crops

        if self.teacher_no_color_jitter:
            out["global_crops_teacher"] = [
                self._norm(self._resize(b, self.global_crops_size))
                for b in bases
            ]
        else:
            out["global_crops_teacher"] = global_crops

        if gram_size is not None:
            src = bases if self.gram_teacher_no_distortions else globals_transf
            out["gram_teacher_crops"] = [
                self._norm(self._resize(img, gram_size)) for img in src
            ]

        if self.local_crops_subset_of_global_crops:
            locals_, offsets = [], []
            gs, ls, p = self.global_crops_size, self.local_crops_size, self.patch_size
            n_half = self.local_crops_number // 2
            for j in range(self.local_crops_number):
                base = bases[0] if j < n_half else bases[1]
                img = self._resize(base, gs)
                if not self.share_color_jitter:
                    img = self._color(rng, img)
                img = gaussian_blur(rng, img, p=0.5)
                arr = self._norm(img)
                rx, ry = (
                    rng.integers(0, (gs - ls) // p, 2).astype(int) * p
                )
                locals_.append(arr[rx: rx + ls, ry: ry + ls])
                offsets.append((int(rx), int(ry)))
            out["local_crops"] = locals_
            out["offsets"] = offsets
        else:
            locals_ = []
            for _ in range(self.local_crops_number):
                img = self._geometric_local(rng, image)
                if not self.share_color_jitter:
                    img = self._color(rng, img)
                img = gaussian_blur(rng, img, p=0.5)
                locals_.append(self._norm(img))
            out["local_crops"] = locals_
            out["offsets"] = ()
        return out


def build_augmentation_from_cfg(cfg) -> DataAugmentationDINO:
    """Construct from the config's ``crops`` and ``train`` sections."""
    crops = cfg.crops
    gram_size = crops.get("gram_teacher_crops_size") or None
    return DataAugmentationDINO(
        global_crops_scale=tuple(crops.global_crops_scale),
        local_crops_scale=tuple(crops.local_crops_scale),
        local_crops_number=crops.local_crops_number,
        global_crops_size=crops.global_crops_size,
        local_crops_size=crops.local_crops_size,
        gram_teacher_crops_size=gram_size,
        gram_teacher_no_distortions=bool(
            crops.get("gram_teacher_no_distortions", False)),
        teacher_no_color_jitter=bool(
            cfg.train.get("teacher_no_color_jitter", False)),
        # the schema spells it localcrops_subset_of_globalcrops; either
        # spelling turns it on
        local_crops_subset_of_global_crops=bool(
            crops.get("localcrops_subset_of_globalcrops", False)
            or crops.get("local_crops_subset_of_global_crops", False)),
        patch_size=cfg.student.patch_size,
        share_color_jitter=bool(crops.get("share_color_jitter", False)),
        horizontal_flips=bool(crops.get("horizontal_flips", True)),
        mean=tuple(crops.get("rgb_mean") or IMAGENET_MEAN),
        std=tuple(crops.get("rgb_std") or IMAGENET_STD),
    )
