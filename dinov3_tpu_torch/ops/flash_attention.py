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

With segment ids, K1 first builds a tile schedule: for each (batch row,
q tile) the ascending list of the key tiles it can meet, from each tile's
min and max id >= 0 and whether it holds a negative id, and walks only
those (a skipped tile's logits are all masked, so skipping changes no
result). ``flash_tile_schedule`` launches that schedule kernel alone;
``flash_tile_schedule_plain`` is its plain twin. The backward keeps the
forward's schedule (64-row q tiles and 64-key tiles in bf16): the bf16 dQ
kernel K2 walks row i of it for q tile i, and, the schedule being
symmetric for equal tile sizes, the bf16 dK/dV kernel K3 walks row j of it
as the list of q tiles that can meet key tile j.
"""

from __future__ import annotations

import ctypes

import torch

from dinov3_tpu_torch.ops._cuda import CudaKernel, stream_ptr

NEG_INF = -1e30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH_FWD = CudaKernel(
    "flash_fwd", "flash_fwd.cu",
    [_P] * 6 + [_I] * 2 + [_P] * 2 + [_I] * 5 + [_L] * 9 + [ctypes.c_float, _P])
FLASH_TILE_SCHEDULE = CudaKernel(
    "flash_tile_schedule", "flash_fwd.cu", [_P] * 3 + [_I] * 4 + [_P],
    built_by=FLASH_FWD)
FLASH_BWD_DQ = CudaKernel(
    "flash_bwd_dq", "flash_bwd_dq.cu",
    [_P] * 11 + [_I] * 5 + [_L] * 15 + [ctypes.c_float, _P])
FLASH_BWD_DKV = CudaKernel(
    "flash_bwd_dkv", "flash_bwd_dkv.cu",
    [_P] * 11 + [_I] * 5 + [_L] * 12 + [ctypes.c_float, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K1's (q tile, key tile) sizes: its schedule is built for these
FWD_TILES = {torch.bfloat16: (64, 64), torch.float32: (64, 32)}


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


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _tile_summary(seg, block):
    """Per tile of ``block`` tokens of each row of seg [B, N]: (min id >= 0,
    max id >= 0, holds a negative id), int64; a tile without ids >= 0 has
    the empty range (2^31 - 1, -1)."""
    B, N = seg.shape
    n = -(-N // block)
    ids = torch.zeros((B, n * block), dtype=torch.int64, device=seg.device)
    ids[:, :N] = seg
    real = torch.arange(n * block, device=seg.device) < N
    nonneg = real & (ids >= 0)
    lo = torch.where(nonneg, ids, 2 ** 31 - 1).view(B, n, block).amin(-1)
    hi = torch.where(nonneg, ids, -1).view(B, n, block).amax(-1)
    neg = (real & (ids < 0)).view(B, n, block).any(-1)
    return lo, hi, neg


def flash_tile_schedule_plain(seg, block_q=64, block_k=64):
    """K1's tile schedule in plain tensor code, for seg [B, N] int32.

    Returns (tiles [B, nQ, nK] int32: for each batch row and q tile the
    ascending key tiles it meets, then -1; counts [B, nQ] int32: the list
    lengths), nQ = ceil(N / block_q), nK = ceil(N / block_k). A q tile and
    a key tile meet if their ranges of ids >= 0 overlap or both hold a
    negative id: every key tile holding a key whose id equals a query's id
    in the q tile is listed, whatever the int32 ids."""
    q_lo, q_hi, q_neg = _tile_summary(seg, block_q)
    k_lo, k_hi, k_neg = _tile_summary(seg, block_k)
    meet = (q_neg[:, :, None] & k_neg[:, None, :]) | (
        torch.maximum(q_lo[:, :, None], k_lo[:, None, :])
        <= torch.minimum(q_hi[:, :, None], k_hi[:, None, :]))
    counts = meet.sum(-1)
    nk = meet.shape[-1]
    # meeting tiles first, in ascending order (a stable sort on "not met")
    order = torch.sort((~meet).to(torch.int8), dim=-1, stable=True).indices
    listed = torch.arange(nk, device=seg.device) < counts[..., None]
    tiles = torch.where(listed, order, -1)
    return tiles.to(torch.int32), counts.to(torch.int32)


def _schedule_buffers(seg, block_q, block_k):
    B, N = seg.shape
    nq, nk = -(-N // block_q), -(-N // block_k)
    return (torch.empty((B, nq, nk), dtype=torch.int32, device=seg.device),
            torch.empty((B, nq), dtype=torch.int32, device=seg.device))


def flash_tile_schedule(seg, block_q=64, block_k=64):
    """K1's tile schedule (see ``flash_tile_schedule_plain``): on a CUDA
    seg it launches only the schedule kernel of ``csrc/flash_fwd.cu``; on a
    CPU seg it is the plain version."""
    if seg.dim() != 2 or seg.dtype != torch.int32 or not seg.is_contiguous():
        raise ValueError(f"seg must be a contiguous int32 [B, N] tensor; got "
                         f"{seg.dtype} {tuple(seg.shape)}")
    if seg.device.type == "cpu":
        return flash_tile_schedule_plain(seg, block_q, block_k)
    tiles, counts = _schedule_buffers(seg, block_q, block_k)
    if seg.numel():
        FLASH_TILE_SCHEDULE.launch(
            seg.data_ptr(), tiles.data_ptr(), counts.data_ptr(), *seg.shape,
            block_q, block_k, stream_ptr(seg.device))
    return tiles, counts


def flash_fwd(q, k, v, seg=None):
    """K1 on CUDA tensors: (O [B, N, h, d] contiguous, LSE [B, h, N],
    schedule). With seg, the one launch builds the tile schedule into
    buffers allocated here, then walks it; schedule is (tiles, counts), for
    the backward, or None without seg."""
    _check(q, k, v, seg)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if out.numel() == 0:  # an empty grid is not a launch
        return out, lse, None
    block_q, block_k = FWD_TILES[q.dtype]
    tiles = counts = None
    if seg is not None:
        tiles, counts = _schedule_buffers(seg, block_q, block_k)
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg),
        _ptr(tiles), _ptr(counts), block_q, block_k,
        out.data_ptr(), lse.data_ptr(), B, N, H, D, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(D) ** -0.5, stream_ptr(q.device))
    return out, lse, None if seg is None else (tiles, counts)


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


def _check_schedule(schedule, seg):
    tiles, counts = schedule
    B, N = seg.shape
    nt = -(-N // 64)
    for name, t, shape in (("tiles", tiles, (B, nt, nt)), ("counts", counts, (B, nt))):
        if t.shape != shape or t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != seg.device:
            raise ValueError(
                f"the schedule's {name} must be a contiguous int32 {shape} "
                f"tensor on {seg.device} (K1's 64 x 64 schedule of seg); got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _walked_schedule(kernel, q, seg, schedule):
    """(tiles, counts) for a backward kernel's launch: K1's 64 x 64
    schedule of seg where the kernel walks one (bf16 with seg), the given
    one checked or one built here (one launch of the schedule kernel);
    (None, None) otherwise. Raises on a schedule the kernel would not
    read."""
    walks = seg is not None and q.dtype == torch.bfloat16
    if schedule is not None and not walks:
        raise ValueError(f"{kernel} reads a schedule only for bf16 inputs "
                         "with segment ids")
    if not walks:
        return None, None
    if schedule is None:
        schedule = flash_tile_schedule(seg, *FWD_TILES[torch.bfloat16])
    _check_schedule(schedule, seg)
    return schedule


def flash_bwd_dq(q, k, v, o, lse, do, seg=None, schedule=None):
    """K2 on CUDA tensors: (dQ [B, N, h, d] contiguous, Delta [B, h, N]
    fp32), Delta = sum_d dO * O for K3.

    With seg and bf16 inputs the kernel walks, for each q tile, only the
    key tiles that can meet it: row i of ``schedule``, K1's (tiles, counts)
    of this seg for 64 x 64 tiles as ``flash_fwd`` returns it (built here,
    one more launch of the schedule kernel, when not given). fp32 walks
    every key tile and takes no schedule."""
    _check(q, k, v, seg)
    _check_bwd(q, lse, o=o, do=do)
    B, N, H, D = q.shape
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    tiles, counts = _walked_schedule("K2", q, seg, schedule)
    FLASH_BWD_DQ.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        _ptr(seg), _ptr(tiles), _ptr(counts), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), B, N, H, D, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], float(D) ** -0.5, stream_ptr(q.device))
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, delta, do, seg=None, schedule=None):
    """K3 on CUDA tensors: (dK, dV), each [B, N, h, d] contiguous.

    With seg and bf16 inputs the kernel walks, for each key tile, only the
    q tiles that can meet it: row j of ``schedule``, K1's (tiles, counts)
    of this seg for 64 x 64 tiles as ``flash_fwd`` returns it (built here,
    one more launch of the schedule kernel, when not given). fp32 walks
    every q tile and takes no schedule."""
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
    tiles, counts = _walked_schedule("K3", q, seg, schedule)
    FLASH_BWD_DKV.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        _ptr(seg), _ptr(tiles), _ptr(counts), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, N, H, D, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        float(D) ** -0.5, stream_ptr(q.device))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg):
        schedule = None
        if q.device.type == "cpu":
            out, lse = attention_plain(q, k, v, seg)
        else:
            out, lse, schedule = flash_fwd(q, k, v, seg)
        # K1's schedule, kept for K2 and K3 where they read it (bf16 with seg)
        tiles = counts = None
        if q.dtype == torch.bfloat16 and schedule is not None:
            tiles, counts = schedule
        ctx.save_for_backward(q, k, v, out, lse, seg, tiles, counts)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse, seg, tiles, counts = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_plain(q, k, v, out, lse, do, seg)
        elif q.numel() == 0:  # an empty grid is not a launch
            dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        else:
            do = do.contiguous()
            schedule = None if tiles is None else (tiles, counts)
            dq, delta = flash_bwd_dq(q, k, v, out, lse, do, seg, schedule)
            dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, seg, schedule)
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
