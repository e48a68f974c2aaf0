"""Kernels K4 and K5: row LayerNorm forward and backward, and their plain
twins.

The TPU kernels they replace are ``dinov3_tpu/ops/fused_norm.py``
``_ln_2d_fwd`` (body ``_fwd_kernel``) and ``_ln_2d_bwd`` (body
``_bwd_kernel``); the Hopper kernels are ``csrc/layernorm.cu`` and
``csrc/layernorm_bwd.cu`` (their headers say what bounds them and what
their designs do). Both normalize over the last dim with fp32 statistics in
the reference's two-pass order (mean, then the mean of squared centred
values), and write y = (x - mean) * rstd * scale + bias once in x's dtype.
The backward recomputes the statistics from x, as the reference does.

``fused_layernorm`` is the entry point: a ``torch.autograd.Function`` whose
forward and backward take the plain versions (``layernorm_plain``,
``layernorm_bwd_plain``) for CPU tensors and launch the kernels for CUDA
tensors, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from dinov3_tpu_torch.debug_nans import check_kernel
from dinov3_tpu_torch.ops._cuda import CudaKernel, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
LAYERNORM_FWD = CudaKernel(
    "layernorm_fwd", "layernorm.cu",
    [_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _I, _P])
LAYERNORM_BWD = CudaKernel(
    "layernorm_bwd", "layernorm_bwd.cu",
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 4096
# K4's vector path (one warp a row, 16-byte loads, the row in registers)
# takes widths up to this; wider rows take the general path
VEC_MAX_WIDTH = 2048
# K5's row pass runs at most this many CTAs of 256 threads, each over a
# fixed run of rows: on the general path 8 resident CTAs on each of the
# H100's 132 SMs, on the vector path 2 (its register cap; more CTAs were
# slower); the column pass sums their partial rows in CTA order
BWD_MAX_CTAS = 8 * 132
BWD_VEC_CTAS = 2 * 132


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 statistics for bf16/fp32 inputs; fp64 stays fp64 (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def layernorm_plain(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last dim: fp32 statistics, output in x's dtype
    (the reference's ``_stats`` order)."""
    xf = x.to(_stats_dtype(x))
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * rstd * scale.to(xf.dtype) + bias.to(xf.dtype)).to(x.dtype)


def layernorm_bwd_plain(x, scale, g, eps: float = 1e-6):
    """(dx, dscale, dbias) of ``layernorm_plain`` given the output gradient
    g, written out from the reference kernel's formulas: statistics
    recomputed from x, dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat))
    with gs = g * scale, dscale = sum g * xhat and dbias = sum g over rows.
    dx comes back in x's dtype, dscale and dbias in scale's."""
    ct = _stats_dtype(x)
    D = x.shape[-1]
    xf = x.reshape(-1, D).to(ct)
    gf = g.reshape(-1, D).to(ct)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    gs = gf * scale.to(ct)
    c1 = gs.mean(dim=-1, keepdim=True)
    c2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (gs - c1 - xhat * c2)
    return (dx.to(x.dtype).reshape(x.shape), (gf * xhat).sum(0).to(scale.dtype),
            gf.sum(0).to(scale.dtype))


def _check(x, scale, bias=None):
    D = x.shape[-1]
    bias = scale if bias is None else bias
    if x.dtype not in _DTYPE_CODE or scale.dtype not in _DTYPE_CODE \
            or bias.dtype != scale.dtype:
        raise ValueError(
            f"fused_layernorm takes bf16 or fp32 x and one bf16 or fp32 "
            f"dtype for scale and bias; got {x.dtype}, {scale.dtype}, "
            f"{bias.dtype}")
    if not 1 <= D <= MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernel takes widths 1..{MAX_WIDTH}, "
                         f"got {D}")
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"scale and bias must be [{D}]; got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("fused_layernorm wants contiguous x, scale and bias")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must lie on one device")


def layernorm_vec_path(D: int, x_dtype: torch.dtype, addresses) -> int:
    """K4's and K5's path for a row width D of x_dtype and the data
    addresses the kernel reads or writes as vectors (K4: x, y, scale and
    bias; K5: x, g and dx): the 16-byte vectors each lane of a warp holds for
    one row on the vector path (1, 2, 4, 8, or 16 for fp32 x), or 0 for
    the general path. The vector path needs D a multiple of one vector (8
    bf16 or 4 fp32 values), D <= VEC_MAX_WIDTH and every address 16-byte
    aligned."""
    per_vec = 128 // torch.finfo(x_dtype).bits
    if D > VEC_MAX_WIDTH or D % per_vec or any(a % 16 for a in addresses):
        return 0
    per_lane = -(-D // (32 * per_vec))
    return 1 << (per_lane - 1).bit_length()


def layernorm_fwd(x, scale, bias, eps: float = 1e-6):
    """K4 on CUDA tensors: y over the [rows, D] view of a contiguous x."""
    _check(x, scale, bias)
    D = x.shape[-1]
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows:
        ptrs = (x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr())
        LAYERNORM_FWD.launch(
            *ptrs, rows, D, float(eps), _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[scale.dtype], layernorm_vec_path(D, x.dtype, ptrs),
            stream_ptr(x.device))
    return y


def layernorm_bwd(x, scale, g, eps: float = 1e-6):
    """K5 on CUDA tensors: (dx, dscale, dbias) for a contiguous x and g of
    one shape. Both of its passes are one launch. Its row pass takes K4's
    vector path where x, g and dx allow it (``layernorm_vec_path``)."""
    _check(x, scale)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device \
            or not g.is_contiguous():
        raise ValueError(
            f"the LayerNorm backward wants a contiguous g like x "
            f"({x.dtype} {tuple(x.shape)}); got {g.dtype} {tuple(g.shape)}")
    D = x.shape[-1]
    rows = x.numel() // D
    dx = torch.empty_like(x)
    if rows == 0:  # no rows: zero parameter gradients, nothing launched
        return dx, torch.zeros_like(scale), torch.zeros_like(scale)
    vec = layernorm_vec_path(D, x.dtype, (x.data_ptr(), g.data_ptr(), dx.data_ptr()))
    per_cta = -(-rows // (BWD_VEC_CTAS if vec else BWD_MAX_CTAS))
    n_cta = -(-rows // per_cta)
    part = torch.empty((2, n_cta, D), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    dbias = torch.empty_like(scale)
    LAYERNORM_BWD.launch(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), part.data_ptr(), rows, D, n_cta,
        per_cta, float(eps), _DTYPE_CODE[x.dtype], _DTYPE_CODE[scale.dtype],
        vec, stream_ptr(x.device))
    return dx, dscale, dbias


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return layernorm_plain(x, scale, bias, eps)
        y = layernorm_fwd(x, scale, bias, eps)
        check_kernel("K4 layernorm_fwd", y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, ds, db = layernorm_bwd_plain(x, scale, g, ctx.eps)
        else:
            dx, ds, db = layernorm_bwd(x, scale, g.contiguous(), ctx.eps)
            check_kernel("K5 layernorm_bwd", dx, ds, db)
        return dx, ds, db, None


def fused_layernorm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm of x [..., D] with scale and bias [D]. On CUDA tensors the
    forward launches K4 (``csrc/layernorm.cu``) and the backward K5
    (``csrc/layernorm_bwd.cu``) over the [rows, D] view of a contiguous x;
    on CPU tensors both take the plain versions."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_layernorm runs on cpu or cuda, not {x.device}")
    return _LayerNorm.apply(x, scale, bias, float(eps))
