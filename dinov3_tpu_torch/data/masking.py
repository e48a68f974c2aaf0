"""BEiT-style block masking with fixed-capacity padded buffers: this
package's numpy copy of ``dinov3_tpu/data/masking.py``, so one seed gives
the JAX package's masks bit for bit.

Block sampling repeatedly places log-uniform-aspect rectangles until the
target count is reached, then randomly tops up or trims to the exact
count, and packs per-image buffers for the meta-arch: token indices,
per-token weights (1/n_masked of the image) and validity.
"""

from __future__ import annotations

import math

import numpy as np


def block_mask(
    rng: np.random.Generator,
    grid: tuple[int, int],
    n_target: int,
    min_aspect: float = 0.3,
    max_attempts: int = 10,
) -> np.ndarray:
    """[H, W] bool mask with approximately n_target True entries."""
    H, W = grid
    mask = np.zeros((H, W), dtype=bool)
    if n_target <= 0:
        return mask
    log_aspect = (math.log(min_aspect), math.log(1.0 / min_aspect))
    count = 0
    for _ in range(max_attempts):
        remaining = n_target - count
        if remaining <= 0:
            break
        # sample a block with area <= remaining
        target_area = rng.uniform(min(4, remaining), max(remaining, 4.01))
        aspect = math.exp(rng.uniform(*log_aspect))
        h = int(round(math.sqrt(target_area * aspect)))
        w = int(round(math.sqrt(target_area / aspect)))
        if h <= 0 or w <= 0 or h > H or w > W:
            continue
        top = rng.integers(0, H - h + 1)
        left = rng.integers(0, W - w + 1)
        region = mask[top: top + h, left: left + w]
        n_new = region.size - region.sum()
        if 0 < n_new:
            mask[top: top + h, left: left + w] = True
            count += n_new
    # exact count: randomly add or remove (reference complete_mask_randomly)
    flat = mask.reshape(-1)
    n_now = int(flat.sum())
    if n_now < n_target:
        off = np.flatnonzero(~flat)
        pick = rng.choice(off, size=n_target - n_now, replace=False)
        flat[pick] = True
    elif n_now > n_target:
        on = np.flatnonzero(flat)
        pick = rng.choice(on, size=n_now - n_target, replace=False)
        flat[pick] = False
    return flat.reshape(H, W)


def sample_ibot_masks(
    rng: np.random.Generator,
    n_images: int,
    n_tokens: int,
    capacity: int,
    grid: tuple[int, int],
    mask_ratio_min_max: tuple[float, float] = (0.1, 0.5),
    mask_probability: float = 0.5,
    random_circular_shift: bool = False,
):
    """Sample per-image block masks and pack fixed-capacity buffers.

    A ``mask_probability`` fraction of images is masked, with per-masked-image
    ratios spread linearly across [min, max] (reference collate.py:47-65's
    linspaced probabilities). ``random_circular_shift`` rolls each block
    mask by a random 2-D offset (reference config
    ibot.mask_random_circular_shift) so block positions lose their
    center bias. Returns (masks [N, T] bool, indices [N, C] int32,
    weights [N, C] f32, valid [N, C] bool).
    """
    lo, hi = mask_ratio_min_max
    n_masked_images = int(round(n_images * mask_probability))
    ratios = np.linspace(lo, hi, max(n_masked_images, 1))
    order = rng.permutation(n_images)
    masks = np.zeros((n_images, n_tokens), dtype=bool)
    indices = np.zeros((n_images, capacity), dtype=np.int32)
    weights = np.zeros((n_images, capacity), dtype=np.float32)
    valid = np.zeros((n_images, capacity), dtype=bool)
    for j in range(n_masked_images):
        img = order[j]
        n_target = min(int(round(ratios[j] * n_tokens)), capacity)
        m2 = block_mask(rng, grid, n_target)
        if random_circular_shift:
            m2 = np.roll(
                m2,
                (int(rng.integers(grid[0])), int(rng.integers(grid[1]))),
                axis=(0, 1),
            )
        m = m2.reshape(-1)
        masks[img] = m
        idx = np.flatnonzero(m)[:capacity]
        k = len(idx)
        if k == 0:
            continue
        indices[img, :k] = idx
        weights[img, :k] = 1.0 / k
        valid[img, :k] = True
    return masks, indices, weights, valid
