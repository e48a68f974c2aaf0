"""Procedural class-structured textures (``dinov3_tpu/data/textures.py``),
written as PNG class folders so the folder pipeline has images to read
where no dataset can be downloaded.

Classes = motif x scale: motifs blobs (isotropic band-pass noise),
stripes (angular-narrow band-pass), cells (Voronoi shading), checker
(noise-warped checkerboard); scales coarse / medium / fine frequency
bands; 12 classes. The palette is drawn per image, so colour carries no
class signal. Everything is numpy; PIL is imported only to write PNGs.
"""

from __future__ import annotations

import os

import numpy as np

MOTIFS = ("blobs", "stripes", "cells", "checker")
SCALES = ("coarse", "medium", "fine")
# radial frequency bands in cycles/image for each named scale. Bands are
# relative to the image, so they survive resizing; the top of "fine" is
# kept under the 32px training-crop Nyquist (16 cycles/image) so the
# class signal is not aliased away by the small-crop recipe.
_BANDS = {"coarse": (2.0, 4.0), "medium": (5.0, 9.0), "fine": (10.0, 15.0)}


def class_names() -> list[str]:
    return [f"{m}_{s}" for m in MOTIFS for s in SCALES]


def _bandpass_noise(rng: np.random.Generator, px: int, band: tuple,
                    angle: float | None = None,
                    angle_width: float = 0.35) -> np.ndarray:
    """Filtered white noise: radial band-pass, optionally angular-masked
    (oriented). Returns a float field roughly in [-1, 1]."""
    noise = rng.standard_normal((px, px))
    f = np.fft.fftfreq(px) * px  # cycles/image
    fx, fy = np.meshgrid(f, f)
    r = np.hypot(fx, fy)
    lo, hi = band
    mask = ((r >= lo) & (r <= hi)).astype(np.float64)
    if angle is not None:
        theta = np.arctan2(fy, fx)
        # distance on the half-circle (spectrum is conjugate-symmetric)
        d = np.abs(((theta - angle) + np.pi / 2) % np.pi - np.pi / 2)
        mask *= np.exp(-((d / angle_width) ** 2))
    spec = np.fft.fft2(noise) * mask
    field = np.real(np.fft.ifft2(spec))
    s = field.std()
    return field / s if s > 0 else field


def _motif_field(rng: np.random.Generator, motif: str, scale: str,
                 px: int) -> np.ndarray:
    band = _BANDS[scale]
    if motif == "blobs":
        field = _bandpass_noise(rng, px, band)
        return np.tanh(2.0 * field)
    if motif == "stripes":
        angle = rng.uniform(0, np.pi)
        field = _bandpass_noise(rng, px, band, angle=angle)
        return np.tanh(2.0 * field)
    if motif == "cells":
        # seed count so mean cell diameter ~ px / mid-band frequency
        n_seeds = max(4, int((0.5 * (band[0] + band[1])) ** 2 // 2))
        seeds = rng.uniform(0, px, size=(n_seeds, 2))
        yy, xx = np.mgrid[0:px, 0:px]
        pts = np.stack([yy.ravel(), xx.ravel()], axis=1)[None]  # 1,P,2
        d2 = ((pts - seeds[:, None]) ** 2).sum(-1)  # S,P
        nearest = d2.argmin(0)
        dist = np.sqrt(d2.min(0))
        shade = (rng.permutation(n_seeds)[nearest] / n_seeds) * 2 - 1
        edge = np.clip(dist / (0.06 * px), 0, 1)  # darken borders
        return (shade * edge).reshape(px, px)
    if motif == "checker":
        freq = 0.5 * (_BANDS[scale][0] + _BANDS[scale][1])
        warp = _bandpass_noise(rng, px, (1.0, 4.0)) * (0.35 * px / freq)
        warp2 = _bandpass_noise(rng, px, (1.0, 4.0)) * (0.35 * px / freq)
        yy, xx = np.mgrid[0:px, 0:px].astype(np.float64)
        u = (xx + warp) * freq / px
        v = (yy + warp2) * freq / px
        return np.sign(np.sin(2 * np.pi * u) * np.sin(2 * np.pi * v)) * (
            0.7 + 0.3 * np.tanh(_bandpass_noise(rng, px, (2.0, 6.0))))
    raise ValueError(f"unknown motif {motif!r}")


def render_texture(rng: np.random.Generator, motif: str, scale: str,
                   px: int = 112) -> np.ndarray:
    """One uint8 RGB texture. Palette is per-image (shared pool across
    classes) so color carries no class signal."""
    field = _motif_field(rng, motif, scale, px)
    t = (field - field.min()) / max(float(np.ptp(field)), 1e-8)  # [0,1]
    # two random anchor colors + mild illumination gradient
    c0, c1 = rng.uniform(30, 225, size=(2, 3))
    img = c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None]
    gy, gx = rng.uniform(-0.15, 0.15, size=2)
    yy, xx = np.mgrid[0:px, 0:px] / px
    img *= (1.0 + gy * (yy - 0.5) + gx * (xx - 0.5))[..., None]
    img += rng.normal(0, 4.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def materialize_textures(root: str, n_train_per_class: int = 150,
                         n_val_per_class: int = 30, px: int = 112,
                         seed: int = 0) -> tuple[str, str]:
    """Write root/{train,val}/<class>/<i>.png; returns (train_dir, val_dir).
    A manifest records the generation parameters: a tree whose manifest
    matches is reused as it is; any mismatch (counts, px or seed)
    regenerates it from scratch."""
    import shutil

    from PIL import Image

    names = class_names()
    train_dir = os.path.join(root, "train")
    val_dir = os.path.join(root, "val")
    manifest_path = os.path.join(root, "manifest.json")
    manifest = {"n_train_per_class": n_train_per_class,
                "n_val_per_class": n_val_per_class, "px": px, "seed": seed,
                "classes": names}
    if os.path.isfile(manifest_path):
        import json

        try:
            with open(manifest_path) as f:
                if json.load(f) == manifest:
                    return train_dir, val_dir
        except ValueError:
            pass  # truncated manifest (killed mid-write): regenerate
    # remove the stale manifest first: if a regeneration is killed
    # mid-write, a surviving manifest would still describe the previous
    # tree, and a later call with the old parameters would reuse the
    # partial one
    try:
        os.remove(manifest_path)
    except OSError:
        pass
    for d in (train_dir, val_dir):
        shutil.rmtree(d, ignore_errors=True)
    rng = np.random.default_rng(seed)
    for ci, name in enumerate(names):
        motif, scale = name.rsplit("_", 1)
        for split_dir, n in ((train_dir, n_train_per_class),
                             (val_dir, n_val_per_class)):
            cls_dir = os.path.join(split_dir, name)
            os.makedirs(cls_dir, exist_ok=True)
            for i in range(n):
                img = render_texture(rng, motif, scale, px)
                Image.fromarray(img).save(os.path.join(cls_dir, f"{i}.png"))
    import json

    # atomic: a kill mid-dump must never leave a truncated manifest
    with open(manifest_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(manifest_path + ".tmp", manifest_path)
    return train_dir, val_dir
