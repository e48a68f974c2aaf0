"""The port's target engines against the JAX package on the CPU: Sinkhorn
with a storage dtype and its log-domain factors, softmax centering and its
EMA center, and the streaming K-tiled cross-entropies
(``dinov3_tpu_torch/losses/streaming.py`` against
``dinov3_tpu/losses/streaming.py``) in value and in student-logit
gradient.

Inputs are made with numpy from a seed and handed to both sides; bf16
arrays cross as their fp32 values (exact).

Tolerances:
- Sinkhorn targets and factors, centered softmax, center EMA: 1e-5
  relative in fp32 (1e-6 for the centers, an fp32 mean and one EMA step);
  with bf16 storage, 2^-7 relative plus 1e-6 (one bf16 ulp of the stored
  iterate or target);
- the streaming CEs: 1e-5 relative in fp32 and 5e-3 with bf16 targets
  (the tolerances of ``tests/test_streaming_targets.py``), against JAX's
  engine on the same factors and against the port's materialized path;
- student-logit gradients against ``jax.grad`` of JAX's engine: 1e-5
  relative to the gradient's largest magnitude, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

K, S, T, B = 192, 4, 2, 6
K_TILE = 50          # choose_k_tile(192, 50) == 48: four tiles
TEMP_T, TEMP_S = 0.07, 0.1


def _np(t):
    return t.detach().float().numpy()


def _jnp(a, dtype=None):
    x = jnp.asarray(np.asarray(a, np.float32))
    return x if dtype is None else x.astype(dtype)


def _torch(a, dtype=torch.float32):
    if isinstance(a, jax.Array):
        a = np.asarray(a.astype(jnp.float32))
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


JDT = {torch.float32: None, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}


def pair_data(seed=0):
    rng = np.random.default_rng(seed)
    sl = (rng.standard_normal((S, B, K)) * 2).astype(np.float32)
    tl = (rng.standard_normal((T, B, K)) * 3).astype(np.float32)
    center = (rng.standard_normal((1, K)) * 0.5).astype(np.float32)
    return sl, tl, center


def row_data(seed=3, M=12, n_valid=8):
    rng = np.random.default_rng(seed)
    sm = rng.standard_normal((M, K)).astype(np.float32)
    tm = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    center = (rng.standard_normal((1, K)) * 0.3).astype(np.float32)
    valid = np.array([1.0] * n_valid + [0.0] * (M - n_valid), np.float32)
    w = np.where(valid > 0, 1.0 / n_valid, 0.0).astype(np.float32)
    return sm, tm, center, valid, w


def port_factors(jf, dtype):
    """JAX SinkhornFactors -> the port's, xs in ``dtype``."""
    from dinov3_tpu_torch.losses import SinkhornFactors

    return SinkhornFactors(
        xs=_torch(jf.xs, dtype), r=_torch(jf.r), c=_torch(jf.c),
        log_B=_torch(jf.log_B),
        valid=None if jf.valid is None else torch.from_numpy(np.array(jf.valid)))


# ---------------- Sinkhorn and softmax centering ----------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sinkhorn_storage_dtype_and_factors_match_jax(dtype, weighted):
    from dinov3_tpu.losses import sinkhorn_knopp as jsk

    from dinov3_tpu_torch.losses import sinkhorn_knopp

    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((12, K)) * 3).astype(np.float32)
    w = (np.arange(12) % 4 != 3).astype(np.float32) if weighted else None
    jkw = dict(row_weights=None if w is None else _jnp(w), storage_dtype=JDT[dtype])
    tkw = dict(row_weights=None if w is None else torch.from_numpy(w),
               storage_dtype=None if dtype == torch.float32 else dtype)
    rtol, atol = (1e-5, 1e-7) if dtype == torch.float32 else (2.0 ** -7, 1e-6)
    want = jsk(_jnp(logits), TEMP_T, **jkw)
    got = sinkhorn_knopp(torch.from_numpy(logits), TEMP_T, **tkw)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    jf = jsk(_jnp(logits), TEMP_T, return_factors=True, **jkw)
    f = sinkhorn_knopp(torch.from_numpy(logits), TEMP_T, return_factors=True, **tkw)
    assert f.xs.dtype == dtype and f.r.dtype == f.c.dtype == torch.float32
    assert f.r.shape == (12, 1) and f.c.shape == (1, K)
    xs_ok = np.abs(np.asarray(jf.xs.astype(jnp.float32))) < 1e29  # padding at -1e30
    np.testing.assert_allclose(_np(f.xs)[xs_ok], np.asarray(jf.xs.astype(jnp.float32))[xs_ok],
                               rtol=rtol, atol=atol)
    for name in ("r", "c"):
        np.testing.assert_allclose(_np(getattr(f, name)), np.asarray(getattr(jf, name)),
                                   rtol=rtol, atol=max(atol, 1e-5), err_msg=name)
    np.testing.assert_allclose(float(f.log_B), float(jf.log_B), rtol=1e-7)
    if weighted:
        assert torch.equal(f.valid, torch.from_numpy(np.array(jf.valid)))
    else:
        assert f.valid is None and jf.valid is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_center_and_update_center_match_jax(dtype):
    from dinov3_tpu.losses import softmax_center_teacher as jsc
    from dinov3_tpu.losses import update_center as jup

    from dinov3_tpu_torch.losses import softmax_center_teacher, update_center

    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((10, K)) * 3).astype(np.float32)
    center = (rng.standard_normal((1, K)) * 0.5).astype(np.float32)
    want = jsc(_jnp(logits), _jnp(center), TEMP_T, storage_dtype=JDT[dtype])
    got = softmax_center_teacher(_torch(logits), _torch(center), TEMP_T,
                                 storage_dtype=None if dtype == torch.float32 else dtype)
    rtol, atol = (1e-5, 1e-8) if dtype == torch.float32 else (2.0 ** -7, 1e-6)
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    # the EMA accumulates fp32 from logits stored in either dtype
    lg = _torch(logits, dtype)
    want_c = jup(_jnp(center), _jnp(_np(lg), JDT[dtype]))
    got_c = update_center(_torch(center), lg)
    assert got_c.dtype == torch.float32
    np.testing.assert_allclose(_np(got_c), np.asarray(want_c), rtol=1e-6, atol=1e-7)


def test_choose_k_tile_matches_jax():
    from dinov3_tpu.losses import choose_k_tile as jchoose

    from dinov3_tpu_torch.losses import choose_k_tile

    for k, cap in ((65536, 8192), (65536, 8000), (300, 128), (64, 8192), (64, 0),
                   (K, K_TILE), (4096, 8192)):
        assert choose_k_tile(k, cap) == jchoose(k, cap), (k, cap)
    assert choose_k_tile(K, K_TILE) == 48


# ---------------- streaming CEs: value ----------------

def jax_pair_spec(kind, tl, center, dtype):
    from dinov3_tpu.losses import sinkhorn_knopp as jsk

    if kind == "softmax_center":
        return {"kind": kind, "logits": _jnp(tl, JDT[dtype]), "center": _jnp(center),
                "temp": TEMP_T}
    return {"kind": kind, "factors": jsk(_jnp(tl).reshape(T * B, K), TEMP_T,
                                         storage_dtype=JDT[dtype], return_factors=True)}


def port_spec(jspec, dtype):
    if jspec["kind"] == "softmax_center":
        return {**jspec, "logits": _torch(jspec["logits"], dtype),
                "center": _torch(jspec["center"])}
    return {"kind": "sinkhorn", "factors": port_factors(jspec["factors"], dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["softmax_center", "sinkhorn"])
def test_pair_ce_streams_like_jax_and_like_the_materialized_path(kind, dtype):
    from dinov3_tpu.losses import pair_ce_from_spec as jpair

    from dinov3_tpu_torch.losses import (
        pair_ce_from_spec,
        sinkhorn_knopp,
        softmax_center_teacher,
    )

    sl, tl, center = pair_data()
    jspec = jax_pair_spec(kind, tl, center, dtype)
    want = np.asarray(jpair(_jnp(sl), jspec, student_temp=TEMP_S, k_tile=K_TILE))
    spec = port_spec(jspec, dtype)
    got = pair_ce_from_spec(_torch(sl), spec, student_temp=TEMP_S, k_tile=K_TILE)
    assert got.shape == (S, T) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=TOL[dtype])
    # the port's materialized targets from the same teacher values, stored
    # in the same dtype
    store = None if dtype == torch.float32 else dtype
    if kind == "softmax_center":
        probs = softmax_center_teacher(spec["logits"].reshape(T * B, K),
                                       _torch(center), TEMP_T, storage_dtype=store)
    else:
        probs = sinkhorn_knopp(_torch(tl).reshape(T * B, K), TEMP_T, storage_dtype=store)
    oracle = pair_ce_from_spec(_torch(sl), {"kind": "probs",
                                            "probs": probs.reshape(T, B, K)},
                               student_temp=TEMP_S)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["softmax_center", "sinkhorn"])
def test_row_ce_streams_like_jax_with_padding_rows(kind, dtype):
    from dinov3_tpu.losses import ibot_loss_from_spec as jibot
    from dinov3_tpu.losses import sinkhorn_knopp as jsk

    from dinov3_tpu_torch.losses import (
        ibot_loss_from_spec,
        sinkhorn_knopp,
        softmax_center_teacher,
    )

    sm, tm, center, valid, w = row_data()
    if kind == "softmax_center":
        jspec = {"kind": kind, "logits": _jnp(tm, JDT[dtype]), "center": _jnp(center),
                 "temp": TEMP_T}
    else:
        jspec = {"kind": kind, "factors": jsk(_jnp(tm), TEMP_T, row_weights=_jnp(valid),
                                              storage_dtype=JDT[dtype],
                                              return_factors=True)}
    want = float(jibot(_jnp(sm), jspec, _jnp(w), 2, student_temp=TEMP_S, k_tile=K_TILE))
    got = ibot_loss_from_spec(_torch(sm), port_spec(jspec, dtype), _torch(w), 2,
                              student_temp=TEMP_S, k_tile=K_TILE)
    np.testing.assert_allclose(float(got), want, rtol=TOL[dtype])
    store = None if dtype == torch.float32 else dtype
    tv = torch.from_numpy(valid)
    if kind == "softmax_center":
        probs = softmax_center_teacher(_torch(tm, dtype), _torch(center), TEMP_T,
                                       storage_dtype=store) * tv[:, None].to(store or torch.float32)
    else:
        probs = sinkhorn_knopp(_torch(tm), TEMP_T, row_weights=tv, storage_dtype=store)
    oracle = ibot_loss_from_spec(_torch(sm), {"kind": "probs", "probs": probs},
                                 _torch(w), 2, student_temp=TEMP_S)
    np.testing.assert_allclose(float(got), float(oracle), rtol=TOL[dtype])


# ---------------- streaming CEs: student-logit gradient ----------------

@pytest.mark.parametrize("form", ["pair", "row"])
@pytest.mark.parametrize("kind", ["softmax_center", "sinkhorn"])
def test_streaming_student_grad_matches_jax_grad(kind, form):
    """Under a random upstream weighting of the [S, T] pair CE (or the
    iBOT parts through the mask weights), fp32."""
    from dinov3_tpu.losses import ibot_loss_from_spec as jibot
    from dinov3_tpu.losses import pair_ce_from_spec as jpair
    from dinov3_tpu.losses import sinkhorn_knopp as jsk

    from dinov3_tpu_torch.losses import ibot_loss_from_spec, pair_ce_from_spec

    dtype = torch.float32
    if form == "pair":
        sl, tl, center = pair_data(seed=7)
        weight = np.random.default_rng(8).standard_normal((S, T)).astype(np.float32)
        jspec = jax_pair_spec(kind, tl, center, dtype)

        def jloss(s):
            return jnp.sum(jpair(s, jspec, student_temp=TEMP_S, k_tile=K_TILE)
                           * _jnp(weight))

        def tloss(s):
            return (pair_ce_from_spec(s, port_spec(jspec, dtype), student_temp=TEMP_S,
                                      k_tile=K_TILE) * _torch(weight)).sum()
    else:
        sl, tm, center, valid, w = row_data(seed=9)
        if kind == "softmax_center":
            jspec = {"kind": kind, "logits": _jnp(tm), "center": _jnp(center),
                     "temp": TEMP_T}
        else:
            jspec = {"kind": kind, "factors": jsk(_jnp(tm), TEMP_T,
                                                  row_weights=_jnp(valid),
                                                  return_factors=True)}

        def jloss(s):
            return jibot(s, jspec, _jnp(w), 2, student_temp=TEMP_S, k_tile=K_TILE)

        def tloss(s):
            return ibot_loss_from_spec(s, port_spec(jspec, dtype), _torch(w), 2,
                                       student_temp=TEMP_S, k_tile=K_TILE)
    want = np.asarray(jax.grad(jloss)(_jnp(sl)))
    s = _torch(sl).requires_grad_()
    tloss(s).backward()
    assert s.grad.dtype == torch.float32 and s.grad.shape == sl.shape
    np.testing.assert_allclose(_np(s.grad), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bf16_student_grad_is_bf16_and_tracks_fp32():
    """bf16 student logits get a bf16 gradient. Against the fp32 gradient
    at the same (bf16-rounded) logits it differs by the bf16 rounding of
    x = s / t_s and of the result: with |x| <= ~4 here, 2^-5 of the
    gradient's largest magnitude."""
    from dinov3_tpu_torch.losses import pair_ce_from_spec

    sl, tl, center = pair_data(seed=11)
    sl = _np(_torch(sl * 0.1, torch.bfloat16))
    spec = {"kind": "softmax_center", "logits": _torch(tl), "center": _torch(center),
            "temp": TEMP_T}
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        s = _torch(sl, dtype).requires_grad_()
        pair_ce_from_spec(s, spec, k_tile=K_TILE).sum().backward()
        assert s.grad.dtype == dtype
        grads[dtype] = _np(s.grad)
    ref = grads[torch.float32]
    np.testing.assert_allclose(grads[torch.bfloat16], ref, rtol=0,
                               atol=2.0 ** -5 * np.abs(ref).max())


# ---------------- no [rows, K] fp32 buffer ----------------

class _Recorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (op, dtype, numel) of every tensor each op returns."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.made.append((str(func), t.dtype, t.numel()))
        return out


@pytest.mark.parametrize("form", ["pair", "row"])
@pytest.mark.parametrize("kind", ["softmax_center", "sinkhorn"])
def test_streaming_ce_makes_no_fp32_rows_by_k_buffer(kind, form):
    """Every tensor that the streaming CE's forward and backward create,
    given bf16 student logits and bf16 targets (factors built under
    ``target_dtype=bf16``, or bf16 teacher logits): none is fp32 with
    rows * K / 2 elements or more. The Sinkhorn iterations that build the
    factors run before the recording (their iterate is unavoidable, in the
    reference as in the port). K = 4096 in tiles of 512."""
    from dinov3_tpu_torch.losses import (
        ibot_loss_from_spec,
        pair_ce_from_spec,
        sinkhorn_knopp,
    )

    k, tile, bf = 4096, 512, torch.bfloat16
    rng = np.random.default_rng(12)
    if form == "pair":
        student = _torch(rng.standard_normal((S, B, k)), bf).requires_grad_()
        teacher = _torch(rng.standard_normal((T, B, k)) * 3, bf)
        rows = max(S, T) * B
        flat_teacher, row_weights = teacher.reshape(T * B, k), None
    else:
        rows = 24
        student = _torch(rng.standard_normal((rows, k)), bf).requires_grad_()
        teacher = _torch(rng.standard_normal((rows, k)) * 3, bf)
        flat_teacher = teacher
        row_weights = torch.from_numpy((np.arange(rows) < 20).astype(np.float32))
    center = _torch(rng.standard_normal((1, k)) * 0.5)
    if kind == "softmax_center":
        spec = {"kind": kind, "logits": teacher, "center": center, "temp": TEMP_T}
    else:
        spec = {"kind": kind, "factors": sinkhorn_knopp(
            flat_teacher, TEMP_T, row_weights=row_weights, storage_dtype=bf,
            return_factors=True)}
        assert spec["factors"].xs.dtype == bf
    mw = torch.full((rows,), 1.0 / rows)
    with _Recorder() as rec:
        if form == "pair":
            loss = pair_ce_from_spec(student, spec, k_tile=tile).sum()
        else:
            loss = ibot_loss_from_spec(student, spec, mw, 2, k_tile=tile)
        loss.backward()
    assert student.grad is not None and student.grad.dtype == bf
    assert len(rec.made) > 50  # the recorder saw the tile loops
    big = [m for m in rec.made if m[1] == torch.float32 and m[2] >= rows * k // 2]
    assert not big, big[:5]
    largest = max(n for _, d, n in rec.made if d == torch.float32)
    assert largest <= rows * tile  # one fp32 tile at most
