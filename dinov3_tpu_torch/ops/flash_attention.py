"""Kernel K1: flash-attention forward with segment ids, and its plain twin.

The TPU kernel it replaces is ``dinov3_tpu/ops/flash_attention.py``
``_flash_fwd`` (body ``_fwd_kernel``); the Hopper kernel is
``csrc/flash_fwd.cu`` (its header says what bounds it and what its design
does). Both compute non-causal attention over [B, N, h, d] with an fp32
online softmax, O in the input dtype and the row log-sum-exp in fp32.
Token q attends token k iff ``seg[b, q] == seg[b, k]`` when segment ids are
given; masked logits take -1e30.

``flash_attention`` is the wrapper: a CPU tensor goes to the plain version
(``attention_plain``, a dense fp32 softmax); a CUDA tensor launches the
kernel or raises. Only the forward exists: the backward kernels (dq and
dk/dv) come with the training slice, so a CUDA call that autograd would
record (grad mode on and an input that requires grad) raises.
"""

from __future__ import annotations

import ctypes

import torch

from dinov3_tpu_torch.ops._cuda import CudaKernel, stream_ptr

NEG_INF = -1e30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd.cu",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v, seg=None):
    """Dense attention: q, k, v [B, N, h, d]; seg optional [B, N] int.

    Returns (O [B, N, h, d] in q's dtype, LSE [B, h, N] fp32). Logits are
    computed in fp32 and scaled by d^-1/2 after the product (the kernel
    scales q first in fp32, or the logits in its bf16 path: the orders
    differ by about one ulp of the logit)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if seg is not None:
        same = seg[:, None, :, None] == seg[:, None, None, :]
        logits = torch.where(same, logits, logits.new_tensor(NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


def _check(q, k, v, seg):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention wants q, k, v of one [B, N, h, d] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in (64, 128):
        raise ValueError(
            f"the flash kernel has head_dim 64 and 128 instances; got "
            f"{q.shape[-1]}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in head_dim")
        # the bf16 kernel loads rows as 16-byte vectors
        if q.dtype == torch.bfloat16 and (
                any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(
                f"{name}'s strides {t.stride()} or address are not 16-byte "
                "aligned for the bf16 kernel")
    if seg is not None:
        if seg.shape != q.shape[:2] or seg.dtype != torch.int32 \
                or not seg.is_contiguous() or seg.device != q.device:
            raise ValueError(
                f"seg must be a contiguous int32 [B, N] tensor on "
                f"{q.device}; got {seg.dtype} {tuple(seg.shape)} on "
                f"{seg.device}")


def flash_attention(q, k, v, seg=None):
    """Attention over [B, N, h, d] with optional [B, N] segment ids.

    Returns (O [B, N, h, d] in q's dtype, LSE [B, h, N] fp32). On CUDA
    tensors this launches K1 (``csrc/flash_fwd.cu``); q, k and v may be
    strided views (last dim contiguous), O comes back contiguous."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no CUDA backward yet: the dq and dk/dv "
            "kernels come with the training slice of the port")
    _check(q, k, v, seg)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if out.numel() == 0:  # an empty grid is not a launch
        return out, lse
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr() if seg is not None else None,
        out.data_ptr(), lse.data_ptr(), B, N, H, D, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(D) ** -0.5, stream_ptr(q.device))
    return out, lse
