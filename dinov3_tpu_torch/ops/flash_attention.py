"""Kernels K1-K3: flash attention with segment ids, forward and backward,
and their plain twins.

The TPU kernels they replace are in ``dinov3_tpu/ops/flash_attention.py``:
K1 ``_flash_fwd`` (body ``_fwd_kernel``), K2 and K3 the two pallas_calls of
``_bwd_pallas`` (bodies ``_dq_kernel`` and ``_dkv_kernel``). The Hopper
kernels are ``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dq.cu`` and
``csrc/flash_bwd_dkv.cu`` (their headers say what bounds them and what
their designs do). They compute non-causal attention over [B, N, h, d]
with an fp32 online softmax, O in the input dtype and the row log-sum-exp
in fp32, and its gradients from the saved O and LSE. Token q attends token
k iff ``seg[b, q] == seg[b, k]`` when segment ids are given; masked logits
take -1e30. The segment ids get no gradient.

``flash_attention`` is the entry point: a ``torch.autograd.Function``
whose forward and backward take the plain versions (``attention_plain``,
``attention_bwd_plain``) for CPU tensors and launch the kernels for CUDA
tensors, or raise.
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
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", "flash_bwd_dq.cu",
    [_P] * 9 + [_I] * 5 + [_L] * 15 + [ctypes.c_float, _P])
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv", "flash_bwd_dkv.cu",
    [_P] * 9 + [_I] * 5 + [_L] * 12 + [ctypes.c_float, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 for bf16/fp32 inputs; fp64 stays fp64 (gradcheck)."""
    return torch.promote_types(q.dtype, torch.float32)


def _masked_logits(q, k, seg, ct):
    """[B, h, N, N] logits in ``ct``, scaled by d^-1/2 after the product,
    -1e30 where the segment ids differ."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * d ** -0.5
    if seg is not None:
        same = seg[:, None, :, None] == seg[:, None, None, :]
        logits = torch.where(same, logits, logits.new_tensor(NEG_INF))
    return logits


def attention_plain(q, k, v, seg=None):
    """Dense attention: q, k, v [B, N, h, d]; seg optional [B, N] int.

    Returns (O [B, N, h, d] in q's dtype, LSE [B, h, N] fp32). Logits are
    computed in fp32 and scaled by d^-1/2 after the product (the kernel
    scales q first in fp32, or the logits in its bf16 path: the orders
    differ by about one ulp of the logit)."""
    ct = _compute_dtype(q)
    logits = _masked_logits(q, k, seg, ct)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(ct))
    return out.to(q.dtype), lse


def attention_bwd_plain(q, k, v, o, lse, do, seg=None):
    """(dq, dk, dv) of attention given the saved O and LSE and the output
    gradient dO, written out from the reference kernels' formulas in fp32:
    P = exp(S * scale - LSE), Delta = sum_d dO * O, dV = P^T dO,
    dS = P * (dO V^T - Delta), dQ = scale * dS K, dK = scale * dS^T Q.
    Each gradient comes back in its input's dtype."""
    ct = _compute_dtype(q)
    scale = q.shape[-1] ** -0.5
    p = torch.exp(_masked_logits(q, k, seg, ct) - lse.to(ct)[..., None])
    dof = do.to(ct)
    delta = (dof * o.to(ct)).sum(-1).transpose(1, 2)        # [B, h, N]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.to(ct))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ct)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ct)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
            f"the flash kernels have head_dim 64 and 128 instances; got "
            f"{q.shape[-1]}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t)
    if seg is not None:
        if seg.shape != q.shape[:2] or seg.dtype != torch.int32 \
                or not seg.is_contiguous() or seg.device != q.device:
            raise ValueError(
                f"seg must be a contiguous int32 [B, N] tensor on "
                f"{q.device}; got {seg.dtype} {tuple(seg.shape)} on "
                f"{seg.device}")


def _check_rows(name, t):
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in head_dim")
    # the bf16 kernels load rows as 16-byte vectors
    if t.dtype == torch.bfloat16 and (
            any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
        raise ValueError(
            f"{name}'s strides {t.stride()} or address are not 16-byte "
            "aligned for the bf16 kernels")


def _seg_ptr(seg):
    return seg.data_ptr() if seg is not None else None


def flash_fwd(q, k, v, seg=None):
    """K1 on CUDA tensors: (O [B, N, h, d] contiguous, LSE [B, h, N])."""
    _check(q, k, v, seg)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if out.numel() == 0:  # an empty grid is not a launch
        return out, lse
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _seg_ptr(seg),
        out.data_ptr(), lse.data_ptr(), B, N, H, D, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(D) ** -0.5, stream_ptr(q.device))
    return out, lse


def _check_bwd(q, lse, **like_q):
    B, N, H, _ = q.shape
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be like q ({q.dtype} "
                             f"{tuple(q.shape)}); got {t.dtype} "
                             f"{tuple(t.shape)}")
        _check_rows(name, t)
    if lse.shape != (B, H, N) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous fp32 [B, h, N] tensor; "
                         f"got {lse.dtype} {tuple(lse.shape)}")


def flash_bwd_dq(q, k, v, o, lse, do, seg=None):
    """K2 on CUDA tensors: (dQ [B, N, h, d] contiguous, Delta [B, h, N]
    fp32), Delta = sum_d dO * O for K3."""
    _check(q, k, v, seg)
    _check_bwd(q, lse, o=o, do=do)
    B, N, H, D = q.shape
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    FLASH_BWD_DQ.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        _seg_ptr(seg), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, N, H, D, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], float(D) ** -0.5, stream_ptr(q.device))
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, delta, do, seg=None):
    """K3 on CUDA tensors: (dK, dV), each [B, N, h, d] contiguous."""
    _check(q, k, v, seg)
    _check_bwd(q, lse, do=do)
    if delta.shape != lse.shape or delta.dtype != torch.float32 \
            or not delta.is_contiguous() or delta.device != q.device:
        raise ValueError("delta must be a contiguous fp32 tensor like lse")
    B, N, H, D = q.shape
    dk = torch.empty((B, N, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, N, H, D), dtype=v.dtype, device=q.device)
    if dk.numel() == 0:
        return dk, dv
    FLASH_BWD_DKV.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        _seg_ptr(seg), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, N, H, D, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        float(D) ** -0.5, stream_ptr(q.device))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg):
        if q.device.type == "cpu":
            out, lse = attention_plain(q, k, v, seg)
        else:
            out, lse = flash_fwd(q, k, v, seg)
        ctx.save_for_backward(q, k, v, out, lse, seg)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, seg = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_plain(q, k, v, out, lse, do, seg)
        elif q.numel() == 0:  # an empty grid is not a launch
            dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        else:
            do = do.contiguous()
            dq, delta = flash_bwd_dq(q, k, v, out, lse, do, seg)
            dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, seg)
        return dq, dk, dv, None


def flash_attention(q, k, v, seg=None):
    """Attention over [B, N, h, d] with optional [B, N] segment ids.

    Returns (O [B, N, h, d] in q's dtype, LSE [B, h, N] fp32; LSE carries
    no gradient). On CUDA tensors the forward launches K1
    (``csrc/flash_fwd.cu``) and the backward K2 then K3
    (``csrc/flash_bwd_dq.cu``, ``csrc/flash_bwd_dkv.cu``); q, k and v may
    be strided views (last dim contiguous)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    return _FlashAttention.apply(q, k, v, seg)
