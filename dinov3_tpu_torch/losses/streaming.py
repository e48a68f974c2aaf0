"""Streaming prototype-axis target/CE engine (``dinov3_tpu/losses/streaming.py``).

The DINO and iBOT cross-entropies computed straight from the teacher's
logits (softmax centering) or from the Sinkhorn factors
(``losses/sinkhorn.py SinkhornFactors``), one K-tile of the prototype
axis at a time. Per tile the forward accumulates in fp32 the teacher's
centered-softmax statistics (online running max and sum-exp), the
student's logsumexp statistics (the same online scheme) and the ``<q, x>``
cross-term, so no ``[rows, K]`` fp32 target or weight buffer exists.

Each CE is a ``torch.autograd.Function`` whose backward walks the tiles
again: it rebuilds that tile's q (or centered-softmax weights) and the
student's softmax from the saved per-row statistics and writes that
tile of the gradient of the student logits, ``(qsum * softmax(x) - q) /
student_temp`` under the upstream cotangent. The reference gets the same
property from a ``jax.checkpoint``-ed scan; the saved residuals here are
the per-row statistics, never a ``[rows, K]`` buffer. Gradients reach
only the student logits (the teacher side comes from no-grad parameters).

Rounding follows the reference: the student tile is divided by the
student temperature in its storage dtype, then promoted to fp32;
truncated Sinkhorn rows use their accumulated ``qsum``, not 1.
"""

from __future__ import annotations

import torch

from dinov3_tpu_torch.losses.dino_loss import dino_pair_ce
from dinov3_tpu_torch.losses.ibot_loss import (
    ibot_patch_loss_from_parts,
    ibot_patch_loss_masked,
)
from dinov3_tpu_torch.losses.sinkhorn import SinkhornFactors


def choose_k_tile(K: int, cap: int) -> int:
    """Largest divisor of K that is <= cap (0 or None: K, one tile)."""
    t = max(1, min(int(cap) if cap else K, K))
    while K % t:
        t -= 1
    return t


def _div_temp(x: torch.Tensor, temp: float) -> torch.Tensor:
    """x / temp in x's storage dtype (the temperature rounded to it)."""
    return x / torch.tensor(temp, dtype=x.dtype)


def _student_tile(student, k0: int, tk: int, s_temp: float) -> torch.Tensor:
    return _div_temp(student[..., k0:k0 + tk], s_temp).float()


def _x_grad(gx: torch.Tensor, dtype, s_temp: float) -> torch.Tensor:
    """The cotangent of the promoted tile back through the storage-dtype
    division by the student temperature."""
    return _div_temp(gx.to(dtype), s_temp)


def _lse_update(m, s, xt):
    """One tile of the online logsumexp over the last axis."""
    new_m = torch.maximum(m, xt.amax(-1))
    s = s * torch.exp(m - new_m) + torch.exp(xt - new_m[..., None]).sum(-1)
    return new_m, s


def _sinkhorn_q(xs, r, c, log_b, k0: int, tk: int) -> torch.Tensor:
    """[R, tk] fp32 tile of q = exp(xs - r - c + log_B)."""
    lq = xs[:, k0:k0 + tk].float() - r
    return lq.sub_(c[:, k0:k0 + tk]).add_(log_b).exp_()


def _centered(t_logits, center, t_temp: float, k0: int, tk: int) -> torch.Tensor:
    """fp32 tile of (l - center) / t_temp."""
    yt = t_logits[..., k0:k0 + tk].float() - center[k0:k0 + tk]
    return yt.div_(t_temp)


# ---------------- pairwise (DINO CLS: every student crop x every
# teacher crop) ----------------

class _PairSoftmaxCE(torch.autograd.Function):
    """[S, B, K] student logits x [T, B, K] teacher logits -> [S, T] CE
    against softmax((l - center) / t_temp), summed over B."""

    @staticmethod
    def forward(ctx, student, t_logits, center, t_temp, s_temp, tk):
        S, B, K = student.shape
        T = t_logits.shape[0]
        f32 = dict(dtype=torch.float32, device=student.device)
        c = center.reshape(-1).float()
        m_t = torch.full((T, B), -torch.inf, **f32)
        s_t = torch.zeros((T, B), **f32)
        dot = torch.zeros((S, T, B), **f32)
        m_s = torch.full((S, B), -torch.inf, **f32)
        s_s = torch.zeros((S, B), **f32)
        for k0 in range(0, K, tk):
            yt = _centered(t_logits, c, t_temp, k0, tk)          # [T, B, tk]
            xt = _student_tile(student, k0, tk, s_temp)         # [S, B, tk]
            new_m_t = torch.maximum(m_t, yt.amax(-1))
            alpha = torch.exp(m_t - new_m_t)
            w = yt.sub_(new_m_t[..., None]).exp_()
            s_t = s_t * alpha + w.sum(-1)
            dot = dot * alpha[None] + torch.einsum("sbk,tbk->stb", xt, w)
            m_t = new_m_t
            m_s, s_s = _lse_update(m_s, s_s, xt)
        lse = m_s + torch.log(s_s)                                # [S, B]
        ctx.save_for_backward(student, t_logits, c, lse, m_t, s_t)
        ctx.t_temp, ctx.s_temp, ctx.tk = t_temp, s_temp, tk
        # the targets sum to exactly 1 per row by construction
        return lse.sum(-1)[:, None] - (dot / s_t[None]).sum(-1)

    @staticmethod
    def backward(ctx, g):
        student, t_logits, c, lse, m_t, s_t = ctx.saved_tensors
        K = student.shape[-1]
        tk = ctx.tk
        g = g.float()
        g_lse = g.sum(1)[:, None, None]                           # [S, 1, 1]
        grad = torch.empty_like(student)
        for k0 in range(0, K, tk):
            q = _centered(t_logits, c, ctx.t_temp, k0, tk)
            q = q.sub_(m_t[..., None]).exp_().div_(s_t[..., None])   # [T, B, tk]
            xt = _student_tile(student, k0, tk, ctx.s_temp)
            p = xt.sub_(lse[..., None]).exp_()
            gx = p.mul_(g_lse).sub_(torch.einsum("st,tbk->sbk", g, q))
            grad[..., k0:k0 + tk] = _x_grad(gx, student.dtype, ctx.s_temp)
        return grad, None, None, None, None, None


class _PairSinkhornCE(torch.autograd.Function):
    """[S, B, K] student logits x Sinkhorn factors of [T * B, K] -> [S, T]
    CE, summed over B."""

    @staticmethod
    def forward(ctx, student, xs, r, c, log_b, s_temp, tk):
        S, B, K = student.shape
        T = xs.shape[0] // B
        f32 = dict(dtype=torch.float32, device=student.device)
        r, c, log_b = r.float(), c.float(), log_b.float()
        dot = torch.zeros((S, T, B), **f32)
        qsum = torch.zeros((T, B), **f32)
        m_s = torch.full((S, B), -torch.inf, **f32)
        s_s = torch.zeros((S, B), **f32)
        for k0 in range(0, K, tk):
            q = _sinkhorn_q(xs, r, c, log_b, k0, tk).reshape(T, B, tk)
            xt = _student_tile(student, k0, tk, s_temp)
            dot = dot + torch.einsum("sbk,tbk->stb", xt, q)
            qsum = qsum + q.sum(-1)
            m_s, s_s = _lse_update(m_s, s_s, xt)
        lse = m_s + torch.log(s_s)
        ctx.save_for_backward(student, xs, r, c, log_b, lse, qsum)
        ctx.s_temp, ctx.tk = s_temp, tk
        # truncated Sinkhorn rows sum to ~1, not exactly 1: the
        # accumulated qsum weighs the logsumexp, as in the oracle
        return torch.einsum("sb,tb->st", lse, qsum) - dot.sum(-1)

    @staticmethod
    def backward(ctx, g):
        student, xs, r, c, log_b, lse, qsum = ctx.saved_tensors
        S, B, K = student.shape
        T, tk = qsum.shape[0], ctx.tk
        g = g.float()
        g_lse = torch.einsum("st,tb->sb", g, qsum)[..., None]    # [S, B, 1]
        grad = torch.empty_like(student)
        for k0 in range(0, K, tk):
            q = _sinkhorn_q(xs, r, c, log_b, k0, tk).reshape(T, B, tk)
            xt = _student_tile(student, k0, tk, ctx.s_temp)
            p = xt.sub_(lse[..., None]).exp_()
            gx = p.mul_(g_lse).sub_(torch.einsum("st,tbk->sbk", g, q))
            grad[..., k0:k0 + tk] = _x_grad(gx, student.dtype, ctx.s_temp)
        return grad, None, None, None, None, None, None


def pair_ce_from_spec(student_logits: torch.Tensor, spec: dict,
                      student_temp: float = 0.1, k_tile: int = 0) -> torch.Tensor:
    """[S, B, K] student logits x a teacher-target spec -> [S, T] pair CE.

    Spec kinds (``SSLMetaArch.teacher_targets_from_features``):
      {"kind": "probs", "probs": [T, B, K]}                  materialized
      {"kind": "softmax_center", "logits": [T, B, K],
       "center": [1, K], "temp": float}                      streaming
      {"kind": "sinkhorn", "factors": SinkhornFactors}       streaming
    """
    kind = spec["kind"]
    if kind == "probs":
        return dino_pair_ce(student_logits, spec["probs"], student_temp=student_temp)
    tk = choose_k_tile(student_logits.shape[-1], k_tile)
    if kind == "softmax_center":
        return _PairSoftmaxCE.apply(student_logits, spec["logits"], spec["center"],
                                    float(spec["temp"]), student_temp, tk)
    if kind == "sinkhorn":
        f: SinkhornFactors = spec["factors"]
        return _PairSinkhornCE.apply(student_logits, f.xs, f.r, f.c, f.log_B,
                                     student_temp, tk)
    raise ValueError(f"unknown teacher-target spec kind {kind!r}")


# ---------------- row-aligned (iBOT: student masked token m x teacher
# masked token m) ----------------

class _RowSoftmaxCE(torch.autograd.Function):
    """[M, K] x [M, K] -> (dot, qsum, lse) per row, q the centered
    softmax of the teacher row (qsum = 1)."""

    @staticmethod
    def forward(ctx, student, t_logits, center, t_temp, s_temp, tk):
        M, K = student.shape
        f32 = dict(dtype=torch.float32, device=student.device)
        c = center.reshape(-1).float()
        m_t = torch.full((M,), -torch.inf, **f32)
        s_t = torch.zeros((M,), **f32)
        dot = torch.zeros((M,), **f32)
        m_s = torch.full((M,), -torch.inf, **f32)
        s_s = torch.zeros((M,), **f32)
        for k0 in range(0, K, tk):
            yt = _centered(t_logits, c, t_temp, k0, tk)
            xt = _student_tile(student, k0, tk, s_temp)
            new_m_t = torch.maximum(m_t, yt.amax(-1))
            alpha = torch.exp(m_t - new_m_t)
            w = yt.sub_(new_m_t[:, None]).exp_()
            s_t = s_t * alpha + w.sum(-1)
            dot = dot * alpha + (xt * w).sum(-1)
            m_t = new_m_t
            m_s, s_s = _lse_update(m_s, s_s, xt)
        lse = m_s + torch.log(s_s)
        ones = torch.ones((M,), **f32)
        ctx.mark_non_differentiable(ones)
        ctx.save_for_backward(student, t_logits, c, lse, m_t, s_t)
        ctx.t_temp, ctx.s_temp, ctx.tk = t_temp, s_temp, tk
        return dot / s_t, ones, lse

    @staticmethod
    def backward(ctx, g_dot, g_qsum, g_lse):
        student, t_logits, c, lse, m_t, s_t = ctx.saved_tensors
        K, tk = student.shape[-1], ctx.tk
        g_dot, g_lse = g_dot.float()[:, None], g_lse.float()[:, None]
        grad = torch.empty_like(student)
        for k0 in range(0, K, tk):
            q = _centered(t_logits, c, ctx.t_temp, k0, tk)
            q = q.sub_(m_t[:, None]).exp_().div_(s_t[:, None])
            xt = _student_tile(student, k0, tk, ctx.s_temp)
            p = xt.sub_(lse[:, None]).exp_()
            gx = p.mul_(g_lse).add_(q.mul_(g_dot))
            grad[:, k0:k0 + tk] = _x_grad(gx, student.dtype, ctx.s_temp)
        return grad, None, None, None, None, None


class _RowSinkhornCE(torch.autograd.Function):
    """[M, K] student logits x Sinkhorn factors of [M, K] -> (dot, qsum,
    lse) per row."""

    @staticmethod
    def forward(ctx, student, xs, r, c, log_b, s_temp, tk):
        M, K = student.shape
        f32 = dict(dtype=torch.float32, device=student.device)
        r, c, log_b = r.float(), c.float(), log_b.float()
        dot = torch.zeros((M,), **f32)
        qsum = torch.zeros((M,), **f32)
        m_s = torch.full((M,), -torch.inf, **f32)
        s_s = torch.zeros((M,), **f32)
        for k0 in range(0, K, tk):
            q = _sinkhorn_q(xs, r, c, log_b, k0, tk)              # [M, tk]
            xt = _student_tile(student, k0, tk, s_temp)
            dot = dot + (xt * q).sum(-1)
            qsum = qsum + q.sum(-1)
            m_s, s_s = _lse_update(m_s, s_s, xt)
        lse = m_s + torch.log(s_s)
        ctx.mark_non_differentiable(qsum)
        ctx.save_for_backward(student, xs, r, c, log_b, lse)
        ctx.s_temp, ctx.tk = s_temp, tk
        return dot, qsum, lse

    @staticmethod
    def backward(ctx, g_dot, g_qsum, g_lse):
        student, xs, r, c, log_b, lse = ctx.saved_tensors
        K, tk = student.shape[-1], ctx.tk
        g_dot, g_lse = g_dot.float()[:, None], g_lse.float()[:, None]
        grad = torch.empty_like(student)
        for k0 in range(0, K, tk):
            q = _sinkhorn_q(xs, r, c, log_b, k0, tk)
            xt = _student_tile(student, k0, tk, ctx.s_temp)
            p = xt.sub_(lse[:, None]).exp_()
            gx = p.mul_(g_lse).add_(q.mul_(g_dot))
            grad[:, k0:k0 + tk] = _x_grad(gx, student.dtype, ctx.s_temp)
        return grad, None, None, None, None, None, None


def ibot_loss_from_spec(student_logits: torch.Tensor, spec: dict,
                        masks_weight: torch.Tensor, n_images: int,
                        student_temp: float = 0.1, k_tile: int = 0) -> torch.Tensor:
    """iBOT masked-token CE of [M, K] student rows against a teacher-target
    spec. Padding rows carry ``masks_weight == 0``, so their streaming CE
    (well defined, meaningless) adds nothing: the materialized path zeroes
    their q rows instead."""
    kind = spec["kind"]
    if kind == "probs":
        return ibot_patch_loss_masked(student_logits, spec["probs"], masks_weight,
                                      n_images, student_temp=student_temp)
    tk = choose_k_tile(student_logits.shape[-1], k_tile)
    if kind == "softmax_center":
        dot, qsum, lse = _RowSoftmaxCE.apply(
            student_logits, spec["logits"], spec["center"], float(spec["temp"]),
            student_temp, tk)
    elif kind == "sinkhorn":
        f: SinkhornFactors = spec["factors"]
        dot, qsum, lse = _RowSinkhornCE.apply(student_logits, f.xs, f.r, f.c,
                                              f.log_B, student_temp, tk)
    else:
        raise ValueError(f"unknown teacher-target spec kind {kind!r}")
    return ibot_patch_loss_from_parts(dot, qsum, lse, masks_weight, n_images)
