"""The port's kernels K1 (flash-attention forward) and K4 (LayerNorm
forward): their plain versions against the JAX Pallas kernels run in
interpret mode, the wrapper rules, and — on a card only — each CUDA
kernel against its plain version.

The JAX side is imported inside the tests that use it, so the CUDA cases
also run where only PyTorch is installed:
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.

Tolerances (stated per case):
- fp32 attention 2e-5 and fp32 LayerNorm 1e-5 (``tests/test_flash_attention.py``
  and ``tests/test_fused_norm.py`` use the same scale): the two sides sum
  in other orders, and the port scales the logits where the JAX kernel
  scales q, which moves a logit by about one ulp;
- bf16 outputs: one bf16 ulp of the larger magnitude, since both sides
  compute in fp32 and round once to bf16, and a last-ulp difference in
  fp32 can flip that rounding;
- the bf16 attention kernel on the card: 2e-2 absolute, because it rounds
  the probabilities to bf16 before the P.V product (relative 2^-8 on
  values below 1) where the plain version keeps them fp32.
"""

import numpy as np
import pytest
import torch

from dinov3_tpu_torch.ops.flash_attention import (
    FLASH_FWD,
    attention_plain,
    flash_attention,
)
from dinov3_tpu_torch.ops.fused_norm import (
    LAYERNORM_FWD,
    fused_layernorm,
    layernorm_plain,
)


def _qkv(seed, B, N, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, h, d)).astype(np.float32)
            for _ in range(3)]


def _seg(seed, B, N, n_seg):
    """[B, N] int32 ids: contiguous runs of n_seg segments and a -1 pad
    tail, as the serve batcher lays a row out."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, N), -1, np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, N - 2), n_seg, replace=False))
        for s, (lo, hi) in enumerate(zip(np.r_[0, cuts[:-1]], cuts)):
            seg[b, lo:hi] = s
    return seg


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# ---------------- plain versions vs the JAX Pallas kernels ----------------

@pytest.mark.parametrize("B,N,h,d,n_seg", [
    (2, 128, 2, 64, 0),     # aligned, no segments
    (1, 201, 3, 64, 0),     # ragged N (the JAX side pads to 256)
    (2, 97, 2, 32, 3),      # ragged N with segment ids and a pad tail
    (1, 300, 2, 64, 5),     # several key blocks, segments
])
def test_flash_plain_matches_jax_pallas(B, N, h, d, n_seg):
    import jax.numpy as jnp

    from dinov3_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(N, B, N, h, d)
    seg = _seg(N + 1, B, N, n_seg) if n_seg else None
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     interpret=True,
                     seg=None if seg is None else jnp.asarray(seg))
    got, lse = attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v)),
        None if seg is None else torch.from_numpy(seg))
    assert got.shape == (B, N, h, d) and lse.shape == (B, h, N)
    np.testing.assert_allclose(_to_np(got), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", [(300, 128), (2, 7, 96), (33, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_plain_matches_jax_pallas(shape, dtype):
    import jax.numpy as jnp

    from dinov3_tpu.ops.fused_norm import fused_layernorm as jax_ln

    rng = np.random.default_rng(shape[-1])
    D = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    s = (rng.standard_normal(D) * 0.5 + 1).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(
        jax_ln(jx, jnp.asarray(s), jnp.asarray(b), 1e-6, interpret=True,
               force=True), np.float32)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    got = layernorm_plain(tx, torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_to_np(got), want, atol=1e-5, rtol=1e-5)
    else:
        err = np.abs(_to_np(got) - want)
        assert (err <= bf16_ulp(np.maximum(np.abs(want), 1e-3))).all(), \
            err.max()


# ---------------- wrapper rules ----------------

def test_cpu_tensors_take_the_plain_versions_with_grad():
    """On CPU the wrappers are the plain versions, autograd included:
    the gradient of K1's plain version matches the JAX kernel's backward
    (interpret mode) at the fp32 gradient tolerance of
    tests/test_flash_attention.py (5e-5)."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(7, 1, 70, 2, 32)
    seg = _seg(8, 1, 70, 2)
    ct = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    launches = FLASH_FWD.launches
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out, _ = flash_attention(tq, tk, tv, torch.from_numpy(seg))
    (out * torch.from_numpy(ct)).sum().backward()
    gq, gk, gv = jax.grad(
        lambda a, b, c: jnp.sum(jax_flash(a, b, c, interpret=True,
                                          seg=jnp.asarray(seg)) * ct),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, want in ((tq.grad, gq), (tk.grad, gk), (tv.grad, gv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=5e-5)
    x = torch.randn(5, 64, requires_grad=True)
    y = fused_layernorm(x, torch.ones(64), torch.zeros(64))
    y.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert FLASH_FWD.launches == launches  # CPU tensors launch nothing


# ---------------- on the card: kernels vs their plain versions ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d,dtype,n_seg,v_view", [
    (4, 2050, 16, 64, "bfloat16", 6, True),   # serve shape, v a qkv view
    (2, 201, 3, 64, "bfloat16", 0, False),     # ragged, no segments
    (1, 130, 2, 128, "bfloat16", 3, False),    # head_dim 128
    (2, 97, 2, 64, "float32", 3, True),
    (1, 200, 2, 128, "float32", 0, False),
])
def test_flash_kernel_matches_plain(cuda_device, B, N, h, d, dtype, n_seg,
                                    v_view):
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dt)
               for t in _qkv(N, B, N, h, d))
    if v_view:  # v as the last third of a fused [B, N, 3*h*d] projection
        fused = torch.cat([q, k, v], dim=2).reshape(B, N, 3 * h * d)
        v = fused[..., 2 * h * d:].reshape(B, N, h, d)
        assert not v.is_contiguous()
    seg = (torch.from_numpy(_seg(N, B, N, n_seg)).to(cuda_device)
           if n_seg else None)
    before = FLASH_FWD.launches
    out, lse = flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    want, want_lse = attention_plain(q, k, v, seg)
    tol = 2e-5 if dt == torch.float32 else 2e-2
    assert out.dtype == dt and out.shape == q.shape
    np.testing.assert_allclose(_to_np(out), _to_np(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_to_np(lse), _to_np(want_lse),
                               atol=10 * tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,dtype,pdtype", [
    (8200, 1024, "bfloat16", "bfloat16"),   # serve shape
    (1000, 96, "bfloat16", "float32"),       # width below one CTA
    (37, 64, "float32", "float32"),
    (3, 4096, "float32", "bfloat16"),        # widest instance
])
def test_layernorm_kernel_matches_plain(cuda_device, R, D, dtype, pdtype):
    g = torch.Generator().manual_seed(R)
    x = (torch.randn(R, D, generator=g) * 3 + 1).to(cuda_device, getattr(torch, dtype))
    s = (torch.randn(D, generator=g) * 0.5 + 1).to(cuda_device, getattr(torch, pdtype))
    b = torch.randn(D, generator=g).to(cuda_device, getattr(torch, pdtype))
    before = LAYERNORM_FWD.launches
    got = fused_layernorm(x, s, b)
    torch.cuda.synchronize()
    assert LAYERNORM_FWD.launches == before + 1
    want = _to_np(layernorm_plain(x, s, b))
    if dtype == "float32":
        np.testing.assert_allclose(_to_np(got), want, atol=1e-5, rtol=1e-5)
    else:
        err = np.abs(_to_np(got) - want)
        assert (err <= bf16_ulp(np.maximum(np.abs(want), 1e-3))).all(), \
            err.max()


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    q = torch.zeros(1, 8, 2, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(q, q, q)
    x = torch.zeros(4, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_layernorm(x, torch.ones(64, device=cuda_device),
                        torch.zeros(64, device=cuda_device))
    empty = torch.zeros(0, 8, 2, 64, device=cuda_device)
    before = FLASH_FWD.launches
    assert flash_attention(empty, empty, empty)[0].shape == empty.shape
    assert FLASH_FWD.launches == before  # an empty grid launches nothing
    bad = torch.zeros(1, 8, 2, 32, device=cuda_device)  # no head_dim-32 kernel
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(bad, bad, bad)
    wide = torch.zeros(2, 8192, device=cuda_device)
    with pytest.raises(ValueError, match="widths"):
        fused_layernorm(wide, torch.ones(8192, device=cuda_device),
                        torch.zeros(8192, device=cuda_device))
