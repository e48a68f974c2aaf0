"""Kernel K4: row LayerNorm forward, and its plain twin.

The TPU kernel it replaces is ``dinov3_tpu/ops/fused_norm.py``
``_ln_2d_fwd`` (body ``_fwd_kernel``); the Hopper kernel is
``csrc/layernorm.cu`` (its header says what bounds it and what its design
does). Both normalize over the last dim with fp32 statistics in the
reference's two-pass order (mean, then the mean of squared centred
values), and write y = (x - mean) * rstd * scale + bias once in x's dtype.

``fused_layernorm`` is the wrapper: a CPU tensor goes to the plain version
(``layernorm_plain``); a CUDA tensor launches the kernel or raises. Only
the forward exists: the backward kernel comes with the training slice,
so a CUDA call that autograd would record (grad mode on and an input that
requires grad) raises.
"""

from __future__ import annotations

import ctypes

import torch

from dinov3_tpu_torch.ops._cuda import CudaKernel, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int
LAYERNORM_FWD = CudaKernel(
    "layernorm_fwd", "layernorm.cu", [_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 4096


def layernorm_plain(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last dim: fp32 statistics, output in x's dtype
    (the reference's ``_stats`` order)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (xc * rstd * scale.float() + bias.float()).to(x.dtype)


def fused_layernorm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm of x [..., D] with scale and bias [D]; on CUDA tensors
    this launches K4 (``csrc/layernorm.cu``) over the [rows, D] view of a
    contiguous x."""
    if x.device.type == "cpu":
        return layernorm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        raise NotImplementedError(
            "fused_layernorm has no CUDA backward yet: the backward kernel "
            "comes with the training slice of the port")
    D = x.shape[-1]
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
    y = torch.empty_like(x)
    rows = x.numel() // D
    if rows:
        LAYERNORM_FWD.launch(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, D, float(eps), _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[scale.dtype], stream_ptr(x.device))
    return y
