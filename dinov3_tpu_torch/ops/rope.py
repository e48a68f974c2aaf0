"""2-D rotary position embeddings for ViT patch grids
(``dinov3_tpu/ops/rope.py``), with the training-time coordinate
augmentation (a global shift, a per-axis log-uniform jitter and an
isotropic log-uniform rescale, ``student.pos_embed_rope_*_coords``), plus
the per-row tables of the crop-packed training batch
(``rope_packed_rows``).

The augmentation factors come from the step's plan (``rng/plan.py``):
``rope_aug_values`` turns five uniforms into them, as the JAX plan does
from its one fused draw, and ``augment_coords`` draws them in three
separate draws from a generator, as the JAX legacy path does.

Angles are computed in fp32 as 2*pi*coords/periods with periods
``base ** (2j / (head_dim/2))`` in fp32, in the reference's order, so
bf16 activations see the same tables.
"""

from __future__ import annotations

import math

import torch


def rope_periods(head_dim: int, base: float | None = 100.0,
                 min_period: float | None = None,
                 max_period: float | None = None,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """[head_dim // 4] period spectrum."""
    if head_dim % 4 != 0:
        raise ValueError(f"head_dim must be divisible by 4, got {head_dim}")
    both = min_period is not None and max_period is not None
    if (base is None) == (not both):
        raise ValueError("provide either `base` or `min_period`+`max_period`")
    n = head_dim // 4
    if base is not None:
        exps = 2.0 * torch.arange(n, dtype=dtype, device=device) / (head_dim / 2.0)
        # a fill on the device, not a host tensor copied over (which waits)
        return torch.full((), base, dtype=dtype, device=device) ** exps
    ratio = max_period / min_period
    exponents = torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
    return (ratio ** exponents) * (max_period / ratio)


def patch_coords(H: int, W: int, normalize: str = "separate",
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """[H*W, 2] patch-center coordinates in [-1, 1] (row-major, ij)."""
    if normalize == "max":
        denom_h = denom_w = max(H, W)
    elif normalize == "min":
        denom_h = denom_w = min(H, W)
    elif normalize == "separate":
        denom_h, denom_w = H, W
    else:
        raise ValueError(f"unknown normalize mode {normalize!r}")
    ch = (torch.arange(H, dtype=dtype, device=device) + 0.5) / denom_h
    cw = (torch.arange(W, dtype=dtype, device=device) + 0.5) / denom_w
    coords = torch.stack(torch.meshgrid(ch, cw, indexing="ij"), dim=-1)
    return 2.0 * coords.reshape(-1, 2) - 1.0


def rope_aug_values(u: torch.Tensor, shift: float | None = None,
                    jitter: float | None = None,
                    rescale: float | None = None) -> dict:
    """Five uniforms in [0, 1) -> the augmentation factors: "shift" [2]
    ~ U[-shift, shift], "jitter" [2] and "rescale" [1] log-uniform over
    [1/j, j]; a null setting gives no entry."""
    out = {}
    if shift is not None:
        out["shift"] = (2.0 * u[0:2] - 1.0) * shift
    if jitter is not None:
        out["jitter"] = torch.exp((2.0 * u[2:4] - 1.0) * math.log(jitter))
    if rescale is not None:
        out["rescale"] = torch.exp((2.0 * u[4:5] - 1.0) * math.log(rescale))
    return out


def augment_coords(generator: torch.Generator, shift: float | None = None,
                   jitter: float | None = None,
                   rescale: float | None = None) -> dict:
    """The factors of ``rope_aug_values`` from three separate draws of
    ``generator`` (shift, jitter, rescale, each drawn whether set or not),
    the port of the JAX ``augment_coords`` draws."""
    u = torch.cat([torch.rand(2, generator=generator),
                   torch.rand(2, generator=generator),
                   torch.rand(1, generator=generator)])
    return rope_aug_values(u, shift, jitter, rescale)


def augment_coords_planned(coords: torch.Tensor, aug: dict) -> torch.Tensor:
    """coords [..., 2] shifted, then scaled per axis, then scaled by one
    factor, with the factors of ``rope_aug_values``."""
    if "shift" in aug:
        coords = coords + aug["shift"].to(coords)
    if "jitter" in aug:
        coords = coords * aug["jitter"].to(coords)
    if "rescale" in aug:
        coords = coords * aug["rescale"].to(coords)
    return coords


def rope_angles_sincos(coords: torch.Tensor, periods: torch.Tensor,
                       dtype=torch.float32):
    """coords [..., 2] -> (sin, cos) [..., 4 * len(periods)]: the
    rotate-half tables, each half holding the [2, P] angles flattened."""
    angles = 2.0 * math.pi * coords[..., None] / periods
    angles = angles.reshape(*coords.shape[:-1], -1)
    angles = torch.cat([angles, angles], dim=-1)
    return torch.sin(angles).to(dtype), torch.cos(angles).to(dtype)


def rope_sincos(H: int, W: int, periods: torch.Tensor,
                normalize: str = "separate", dtype=torch.float32,
                aug: dict | None = None):
    """(sin, cos), each [H*W, head_dim], for an H x W patch grid; ``aug``:
    the augmentation factors (``rope_aug_values``) applied to the fp32
    coordinates first."""
    coords = patch_coords(H, W, normalize, device=periods.device)
    if aug:
        coords = augment_coords_planned(coords, aug)
    return rope_angles_sincos(coords, periods, dtype)


def rope_with_identity_prefix(sin: torch.Tensor, cos: torch.Tensor,
                              n_prefix: int):
    """Prepend identity rotations (sin 0, cos 1) for CLS/storage tokens."""
    if n_prefix == 0:
        return sin, cos
    d = sin.shape[-1]
    return (torch.cat([sin.new_zeros(n_prefix, d), sin], dim=0),
            torch.cat([cos.new_ones(n_prefix, d), cos], dim=0))


def rope_apply_full(q: torch.Tensor, k: torch.Tensor, sin: torch.Tensor,
                    cos: torch.Tensor):
    """Rotate q, k [B, N, heads, head_dim] by a full-length table: [N, hd]
    shared by every row, or [B, N, hd] per row (the packed serve planes).

    Half-pair form (out1 = x1*c - x2*s, out2 = x2*c + x1*s) computed in
    the promoted dtype of q and the table (fp32 tables upcast bf16 q/k),
    then cast back to q's dtype."""
    compute = torch.promote_types(q.dtype, sin.dtype)
    half = sin.shape[-1] // 2
    if sin.dim() == 3:
        s = sin[:, :, None, :half].to(compute)
        c = cos[:, :, None, :half].to(compute)
    else:
        s = sin[None, :, None, :half].to(compute)
        c = cos[None, :, None, :half].to(compute)

    def rot(t):
        x = t.to(compute)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(t.dtype)

    return rot(q), rot(k)


def rope_packed_rows(global_table, local_table, layout):
    """Per-row (sin, cos) tables, each [R, N_g, head_dim], for a crop-packed
    batch (``ops/packing.py``): global rows take the global table; packed
    rows tile the local table k times (each segment keeps its own grid and
    identity prefix rows) and end in identity rotations over the row-tail
    pads. Both tables carry their identity prefix rows already."""
    sin_g, cos_g = global_table
    sin_l, cos_l = local_table
    d = sin_g.shape[-1]
    pad = layout.pad_tokens_per_row
    sin_p = torch.cat([sin_l.repeat(layout.k, 1), sin_l.new_zeros(pad, d)])
    cos_p = torch.cat([cos_l.repeat(layout.k, 1), cos_l.new_ones(pad, d)])

    def rows(g, p):
        return torch.cat([g[None].expand(layout.n_global_rows, -1, -1),
                          p[None].expand(layout.n_packed_rows, -1, -1)])

    return rows(sin_g, sin_p), rows(cos_g, cos_p)
