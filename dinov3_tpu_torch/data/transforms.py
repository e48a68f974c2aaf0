"""Image transforms on PIL images and numpy arrays
(``dinov3_tpu/data/transforms.py``: the ops the SSL augmentation uses and
the classification presets of the eval harness).

Every random op takes an explicit ``np.random.Generator``, no global RNG,
so a sample's crops are a function of (seed, sample index). The colour
jitter and the normalization take the JAX package's numpy paths, so the
same image bytes, generator and parameters give the same arrays bit for
bit.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from PIL import Image, ImageFilter, ImageOps

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ------------------------------------------------------------ geometric ops


def random_resized_crop(
    rng: np.random.Generator,
    img: Image.Image,
    size: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    interpolation=Image.BICUBIC,
) -> Image.Image:
    """torchvision RandomResizedCrop semantics: 10 tries of area/aspect
    sampling, fallback to center crop."""
    W, H = img.size
    area = W * H
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            left = int(rng.integers(0, W - w + 1))
            top = int(rng.integers(0, H - h + 1))
            return img.resize(
                (size, size), interpolation, box=(left, top, left + w, top + h)
            )
    # fallback: largest center crop with in-range aspect
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(H * ratio[1])), H
    else:
        w, h = W, H
    left, top = (W - w) // 2, (H - h) // 2
    return img.resize(
        (size, size), interpolation, box=(left, top, left + w, top + h)
    )


def resize_shorter_side(
    img: Image.Image, size: int, interpolation=Image.BICUBIC
) -> Image.Image:
    W, H = img.size
    if W <= H:
        new = (size, max(1, int(round(H * size / W))))
    else:
        new = (max(1, int(round(W * size / H))), size)
    return img.resize(new, interpolation)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    W, H = img.size
    left = (W - size) // 2
    top = (H - size) // 2
    return img.crop((left, top, left + size, top + size))


def maybe_hflip(rng: np.random.Generator, img: Image.Image, p: float = 0.5):
    if rng.uniform() < p:
        return img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


# ----------------------------------------------------------- photometric ops


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(b + factor * (a - b), 0.0, 255.0)


def _rgb_to_gray(arr: np.ndarray) -> np.ndarray:
    # ITU-R 601-2 luma, matching PIL convert("L") / torchvision
    return (arr @ np.asarray([0.299, 0.587, 0.114], arr.dtype))[..., None]


def adjust_brightness(arr: np.ndarray, factor: float) -> np.ndarray:
    return _blend(arr, np.zeros_like(arr), factor)


def adjust_contrast(arr: np.ndarray, factor: float) -> np.ndarray:
    mean = _rgb_to_gray(arr).mean()
    return _blend(arr, np.full_like(arr, mean), factor)


def adjust_saturation(arr: np.ndarray, factor: float) -> np.ndarray:
    return _blend(arr, np.broadcast_to(_rgb_to_gray(arr), arr.shape), factor)


def adjust_hue(arr: np.ndarray, delta: float) -> np.ndarray:
    """Shift hue by ``delta`` (fraction of the color wheel, [-0.5, 0.5])."""
    if delta == 0.0:
        return arr
    x = arr / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(axis=-1)
    minc = x.min(axis=-1)
    v = maxc
    c = maxc - minc
    s = np.where(maxc > 0, c / np.maximum(maxc, 1e-12), 0.0)
    safe_c = np.maximum(c, 1e-12)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = np.where(
        r == maxc, bc - gc, np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = np.where(c > 0, (h / 6.0) % 1.0, 0.0)
    h = (h + delta) % 1.0
    # hsv -> rgb
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.astype(np.int32) % 6)[..., None]
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [
            np.stack([v, t, p], -1), np.stack([q, v, p], -1),
            np.stack([p, v, t], -1), np.stack([p, q, v], -1),
            np.stack([t, p, v], -1), np.stack([v, p, q], -1),
        ],
    )
    return np.clip(out * 255.0, 0.0, 255.0)


class ColorJitter:
    """torchvision ColorJitter semantics: random factor per property, random
    op order."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        if not 0.0 <= hue <= 0.5:
            # half the color wheel each way is the full hue range
            raise ValueError(f"hue must be in [0, 0.5], got {hue}")
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def sample_params(self, rng: np.random.Generator):
        def factor(v):
            return rng.uniform(max(0.0, 1.0 - v), 1.0 + v) if v else None

        return {
            "order": rng.permutation(4),
            "brightness": factor(self.brightness),
            "contrast": factor(self.contrast),
            "saturation": factor(self.saturation),
            "hue": rng.uniform(-self.hue, self.hue) if self.hue else None,
        }

    def apply_with_params(self, img: Image.Image, p) -> Image.Image:
        arr = np.asarray(img, np.float32)
        for op in p["order"]:
            if op == 0 and p["brightness"] is not None:
                arr = adjust_brightness(arr, p["brightness"])
            elif op == 1 and p["contrast"] is not None:
                arr = adjust_contrast(arr, p["contrast"])
            elif op == 2 and p["saturation"] is not None:
                arr = adjust_saturation(arr, p["saturation"])
            elif op == 3 and p["hue"] is not None:
                arr = adjust_hue(arr, p["hue"])
        return Image.fromarray(arr.astype(np.uint8))

    def __call__(self, rng: np.random.Generator, img: Image.Image):
        return self.apply_with_params(img, self.sample_params(rng))


def maybe_grayscale(rng, img: Image.Image, p: float = 0.2) -> Image.Image:
    if rng.uniform() < p:
        return img.convert("L").convert("RGB")
    return img


def gaussian_blur(
    rng, img: Image.Image, p: float = 0.5,
    sigma: tuple[float, float] = (0.1, 2.0),
) -> Image.Image:
    """torchvision v2 GaussianBlur with a random sigma; PIL's GaussianBlur
    radius is the sigma."""
    if p < 1.0 and rng.uniform() >= p:
        return img
    s = rng.uniform(*sigma)
    return img.filter(ImageFilter.GaussianBlur(radius=s))


def maybe_solarize(rng, img: Image.Image, p: float = 0.2, threshold=128):
    if rng.uniform() < p:
        return ImageOps.solarize(img, threshold)
    return img


# --------------------------------------------------------------- finalizers


def to_normalized_array(
    img: Image.Image,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> np.ndarray:
    """PIL -> float32 [H, W, 3], scaled to [0, 1] then normalized (the
    numpy path; the JAX package's host C++ normalize kernel is not
    ported, ROADMAP)."""
    arr_u8 = np.asarray(img.convert("RGB"), np.uint8)
    arr = arr_u8.astype(np.float32) / 255.0
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (arr - mean) / std


# -------------------------------------------------- classification presets


def make_classification_train_transform(
    crop_size: int = 224,
    hflip_prob: float = 0.5,
    jitter: ColorJitter | None = None,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
):
    """(rng, PIL image) -> float32 [crop, crop, 3]: random resized crop,
    horizontal flip, optional colour jitter, normalization (the eval
    harness's train-split transform)."""

    def transform(rng: np.random.Generator, img: Image.Image) -> np.ndarray:
        img = random_resized_crop(rng, img, crop_size)
        img = maybe_hflip(rng, img, hflip_prob)
        if jitter is not None:
            img = jitter(rng, img)
        return to_normalized_array(img, mean, std)

    return transform


def make_classification_eval_transform(
    resize_size: int = 256,
    crop_size: int = 224,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
):
    """(rng, PIL image) -> float32 [crop, crop, 3]: shorter side resized to
    ``resize_size``, centre crop, normalization; ``rng`` is not drawn
    from."""

    def transform(rng: np.random.Generator, img: Image.Image) -> np.ndarray:
        img = resize_shorter_side(img, resize_size)
        img = center_crop(img, crop_size)
        return to_normalized_array(img, mean, std)

    return transform
