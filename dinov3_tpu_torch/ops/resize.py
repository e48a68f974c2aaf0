"""JAX's grid resize (``jax.image.resize``, through its
``scale_and_translate``), written out, for the Gram teacher's patch grid
(``gram.global_teacher_resize_method`` / ``_antialias``).

Each resized axis is one [out, in] weight matrix applied as a product:
output sample i sits at (i + 0.5) / scale - 0.5 in input coordinates
(scale = out / in); the kernel, widened by 1 / scale only when
``antialias`` and downsampling, weighs each input sample by its
distance; each column of weights is renormalised to sum to one (so taps
that fall outside the grid are dropped, not clamped), and a sample whose
centre lies outside the input takes 0. Kernels: Keys cubic with a = -0.5
(``cubic``, ``bicubic``), the triangle (``linear``, ``bilinear``,
``triangle``) and Lanczos of radius 3 and 5; ``nearest`` picks input
floor((i + 0.5) * in / out). ``F.interpolate(mode="bicubic")`` computes
something else (a = -0.75, clamped borders) and is not used.
"""

from __future__ import annotations

import functools
import math

import torch


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return (1.0 - x.abs()).clamp(min=0.0)


def _lanczos(radius: float, x):
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi ** 2 * x * x, 1.0), 1.0)
    return torch.where(x > radius, 0.0, out)


_KERNELS = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"), _triangle),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    "lanczos3": functools.partial(_lanczos, 3.0),
    "lanczos5": functools.partial(_lanczos, 5.0),
}


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str,
                   antialias: bool) -> torch.Tensor:
    """The [out, in] fp32 weights of one axis (``compute_weight_mat`` of
    ``jax.image``, transposed), on the CPU; built once per shape."""
    kernel = _KERNELS.get(method)
    if kernel is None:
        raise ValueError(f"unknown resize method {method!r}")
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    f32 = torch.float32
    sample = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[:, None] - torch.arange(in_size, dtype=f32)[None, :]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def resize_grid(x: torch.Tensor, size: tuple[int, int], method: str = "bicubic",
                antialias: bool = False) -> torch.Tensor:
    """x [B, h, w, C] -> [B, H, W, C] as ``jax.image.resize(x, (B, H, W,
    C), method, antialias)`` computes it: an axis whose size does not
    change is left as it is; the weights take x's dtype, as in JAX."""
    H, W = size
    _, h, w, _ = x.shape
    if method == "nearest":
        for axis, (n_in, n_out) in ((1, (h, H)), (2, (w, W))):
            if n_in != n_out:
                idx = ((torch.arange(n_out, dtype=torch.float32) + 0.5)
                       * n_in / n_out).floor().long()
                x = x.index_select(axis, idx.to(x.device))
        return x
    if h != H:
        wh = resize_weights(h, H, method, antialias).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", wh, x)
    if w != W:
        ww = resize_weights(w, W, method, antialias).to(x.device, x.dtype)
        x = torch.einsum("ow,bhwc->bhoc", ww, x)
    return x
