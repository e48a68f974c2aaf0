"""The port's kernels K1-K3 (flash attention forward, dQ and dK/dV) and
K4-K5 (LayerNorm forward and backward): their plain versions against the
JAX Pallas kernels run in interpret mode, the autograd Functions against
``torch.autograd.gradcheck``, the wrapper rules, and — on a card only —
each CUDA kernel against its plain version.

The JAX side is imported inside the tests that use it, so the CUDA cases
also run where only PyTorch is installed:
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``.

Tolerances (stated per case):
- fp32 attention 2e-5 and fp32 LayerNorm 1e-5 (``tests/test_flash_attention.py``
  and ``tests/test_fused_norm.py`` use the same scale): the two sides sum
  in other orders, and the port scales the logits where the JAX kernel
  scales q, which moves a logit by about one ulp;
- fp32 attention gradients 5e-5, the JAX package's own gradient tolerance
  (``tests/test_flash_attention.py``); fp32 LayerNorm gradients 1e-5
  relative to the gradient's scale (sums over up to 300 rows);
- bf16 outputs: one bf16 ulp of the larger magnitude, since both sides
  compute in fp32 and round once to bf16, and a last-ulp difference in
  fp32 can flip that rounding;
- the bf16 attention kernel on the card: 2e-2 absolute, because it rounds
  the probabilities to bf16 before the P.V product (relative 2^-8 on
  values below 1) where the plain version keeps them fp32;
- the bf16 backward kernels on the card: 2^-6 of the gradient's largest
  magnitude, because they round P and dS to bf16 before the second
  products (relative 2^-8 each, summed over up to N keys or rows with
  both signs) and write the result in bf16 where the plain version keeps
  fp32; fp32 backward kernels 1e-4 of that magnitude;
- the LayerNorm backward kernel on the card: dx one bf16 ulp plus 2^-8 of
  its row scale in bf16 and 1e-5 in fp32; dscale and dbias 1e-4 of their
  magnitude (fp32 sums in another order).
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from dinov3_tpu_torch.ops._cuda import CudaKernel, source_files
from dinov3_tpu_torch.ops.flash_attention import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    FLASH_TILE_SCHEDULE,
    FWD_TILES,
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
    flash_tile_schedule,
    flash_tile_schedule_plain,
)
from dinov3_tpu_torch.ops.fused_norm import (
    LAYERNORM_BWD,
    LAYERNORM_FWD,
    fused_layernorm,
    layernorm_bwd_plain,
    layernorm_plain,
    layernorm_vec_path,
)

REPO = Path(__file__).resolve().parent.parent


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


def _seg_kind(kind, seed, B, N):
    """[B, N] int32 ids of one kind: ``runs`` (sorted runs and a -1 pad
    tail, as the serve batcher lays a row out), ``shuffled`` (those ids in
    random order), ``wide`` (a few ids spread over the int32 range,
    negative ones included, in random order), ``allpad`` (runs with one
    row of nothing but -1)."""
    rng = np.random.default_rng(seed)
    if kind == "wide":
        ids = np.array([-2 ** 31, -7, -1, 0, 5, 123456789, 2 ** 31 - 1], np.int32)
        return ids[rng.integers(0, len(ids), (B, N))]
    seg = _seg(seed, B, N, min(4, N - 3)) if N > 4 else np.zeros((B, N), np.int32)
    if kind == "shuffled":
        seg = np.stack([rng.permutation(row) for row in seg])
    if kind == "allpad":
        seg[B // 2] = -1
    return seg


def _visited(seg, block_q, block_k):
    """[B, N, N] bool: key j lies in a tile on the schedule list of query
    i's q tile."""
    tiles, counts = flash_tile_schedule_plain(seg, block_q, block_k)
    B, N = seg.shape
    nk = tiles.shape[-1]
    listed = torch.zeros(B, tiles.shape[1], nk + 1, dtype=torch.bool)
    listed.scatter_(2, torch.where(tiles < 0, nk, tiles).long(), True)
    qt, kt = torch.arange(N) // block_q, torch.arange(N) // block_k
    return listed[:, qt][:, :, kt]


def _attention_on_schedule(q, k, v, seg, block_q=64, block_k=64):
    """fp32 attention that, like K1, computes only the logits of the key
    tiles on each q tile's schedule list (the rest count as masked)."""
    keep = (seg[:, :, None] == seg[:, None, :]) & _visited(seg, block_q, block_k)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    logits = torch.where(keep[:, None], logits, logits.new_tensor(-1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


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
    if seg is not None:  # K1 walks only its schedule's key tiles
        on_schedule = _attention_on_schedule(
            *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(seg))
        np.testing.assert_allclose(_to_np(on_schedule), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kind", ["runs", "shuffled", "wide", "allpad"])
@pytest.mark.parametrize("N", [37, 130, 300])
def test_flash_on_schedule_matches_plain_and_jax_pallas(kind, N):
    """Attention restricted to the schedule's key tiles (K1's bf16 and
    fp32 tile sizes) equals the dense plain version and the JAX flash
    kernel (Pallas, interpret mode) in fp32 at 2e-5, for sorted, shuffled,
    int32-wide and all-pad segment ids, N below one tile and ragged."""
    import jax.numpy as jnp

    from dinov3_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(N + 7, 3, N, 2, 64)
    seg = _seg_kind(kind, N, 3, N)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                interpret=True, seg=jnp.asarray(seg)))
    tq, tk, tv, tseg = (torch.from_numpy(t) for t in (q, k, v, seg))
    plain, _ = attention_plain(tq, tk, tv, tseg)
    np.testing.assert_allclose(_to_np(plain), want, atol=2e-5, rtol=2e-5)
    for block_q, block_k in FWD_TILES.values():
        got = _attention_on_schedule(tq, tk, tv, tseg, block_q, block_k)
        np.testing.assert_allclose(_to_np(got), want, atol=2e-5, rtol=2e-5)


# ---------------- K1's tile schedule ----------------

@pytest.mark.parametrize("kind", ["runs", "shuffled", "wide", "allpad"])
@pytest.mark.parametrize("N", [1, 5, 63, 64, 197, 300])
@pytest.mark.parametrize("blocks", [(128, 64), (64, 64), (64, 32), (16, 8), (8, 16)])
def test_tile_schedule_is_conservative(kind, N, blocks):
    """Every pair of tokens that meets (equal ids) has its key tile on the
    list of its query's tile; each list is ascending without repeats, its
    length is the count, and -1 fills the rest."""
    block_q, block_k = blocks
    seg = torch.from_numpy(_seg_kind(kind, 3 * N + block_k, 4, N))
    tiles, counts = flash_tile_schedule(seg, block_q, block_k)  # CPU: plain
    nq, nk = -(-N // block_q), -(-N // block_k)
    assert tiles.shape == (4, nq, nk) and counts.shape == (4, nq)
    assert tiles.dtype == counts.dtype == torch.int32
    for b in range(4):
        for i in range(nq):
            c = int(counts[b, i])
            row = tiles[b, i].tolist()
            assert row[c:] == [-1] * (nk - c)
            assert row[:c] == sorted(set(row[:c])) and all(0 <= j < nk for j in row[:c])
    meet = seg[:, :, None] == seg[:, None, :]
    assert not (meet & ~_visited(seg, block_q, block_k)).any()


def test_tile_schedule_skips_disjoint_tiles():
    """The summary is tight where ids are sorted runs: tiles whose ranges
    of ids >= 0 do not overlap are skipped, and pad tiles meet only tiles
    holding pad ids."""
    seg = torch.tensor([[0] * 64 + [1] * 64 + [2] * 60 + [-1] * 4], dtype=torch.int32)
    tiles, counts = flash_tile_schedule_plain(seg, 64, 64)
    assert counts.tolist() == [[1, 1, 1]]
    assert tiles.tolist() == [[[0, -1, -1], [1, -1, -1], [2, -1, -1]]]
    seg[0, 60:70] = -1  # tiles 0 and 1 now both hold a pad id
    tiles, counts = flash_tile_schedule_plain(seg, 64, 64)
    assert tiles.tolist() == [[[0, 1, 2], [0, 1, 2], [0, 1, 2]]]


def dkv_tile_lists(tiles):
    """K3's q-tile lists as it reads them from K1's 64 x 64 schedule:
    [B, key tile j, q tile i] bool, True where i is in row j of tiles."""
    B, nq, nk = tiles.shape
    assert nq == nk
    listed = torch.zeros(B, nk, nq + 1, dtype=torch.bool)
    listed.scatter_(2, torch.where(tiles < 0, nq, tiles).long(), True)
    return listed[..., :nq]


@pytest.mark.parametrize("kind", ["runs", "shuffled", "wide", "allpad"])
@pytest.mark.parametrize("N", [1, 63, 64, 197, 300])
def test_dkv_q_tile_lists_are_the_transposed_schedule(kind, N):
    """K3 reads its q-tile lists as the rows of K1's 64 x 64 schedule. That
    is exact because the schedule is symmetric for equal tile sizes, and
    the lists cover every (query, key) pair with equal ids: each key
    tile's list holds the q tile of every query that meets one of its
    keys."""
    seg = torch.from_numpy(_seg_kind(kind, 5 * N + 1, 4, N))
    tiles, counts = flash_tile_schedule_plain(seg, 64, 64)
    listed = dkv_tile_lists(tiles)  # [B, key tile, q tile]
    assert torch.equal(listed, listed.transpose(1, 2))
    assert torch.equal(listed.sum(-1), counts.long())
    pos = torch.arange(N) // 64
    walked = listed[:, pos][:, :, pos]  # [B, key, query]
    meet = seg[:, :, None] == seg[:, None, :]
    assert not (meet & ~walked).any()


@pytest.mark.parametrize("kind", ["runs", "shuffled", "wide", "allpad"])
def test_dkv_on_q_tile_lists_matches_plain(kind):
    """dK and dV summed, as K3 sums them, only over the q tiles on each key
    tile's list equal the dense plain backward (fp32, 1e-6 relative to the
    gradient's scale: the same sums with masked terms left out)."""
    B, N, h, d = 3, 201, 2, 64
    q, k, v = (torch.from_numpy(t) for t in _qkv(N + 11, B, N, h, d))
    do = torch.from_numpy(_qkv(N + 12, B, N, h, d)[0])
    seg = torch.from_numpy(_seg_kind(kind, N + 13, B, N))
    o, lse = attention_plain(q, k, v, seg)
    _, want_dk, want_dv = attention_bwd_plain(q, k, v, o, lse, do, seg)
    pos = torch.arange(N) // 64
    walked = dkv_tile_lists(flash_tile_schedule_plain(seg)[0])[:, pos][:, :, pos]
    keep = (seg[:, :, None] == seg[:, None, :]) & walked.transpose(1, 2)  # [B, q, k]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    p = torch.where(keep[:, None], torch.exp(logits - lse[..., None]), 0.0)
    delta = (do * o).sum(-1).transpose(1, 2)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * d ** -0.5
    for got, want in ((dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("kind", ["runs", "shuffled", "wide", "allpad"])
def test_dq_on_key_tile_lists_matches_plain(kind):
    """dQ summed, as K2 sums it, only over the key tiles on each q tile's
    row of K1's 64 x 64 schedule equals the dense plain backward (fp32,
    1e-6 relative to the gradient's scale: the same sums with masked terms
    left out)."""
    B, N, h, d = 3, 201, 2, 64
    q, k, v = (torch.from_numpy(t) for t in _qkv(N + 21, B, N, h, d))
    do = torch.from_numpy(_qkv(N + 22, B, N, h, d)[0])
    seg = torch.from_numpy(_seg_kind(kind, N + 23, B, N))
    o, lse = attention_plain(q, k, v, seg)
    want_dq, _, _ = attention_bwd_plain(q, k, v, o, lse, do, seg)
    keep = (seg[:, :, None] == seg[:, None, :]) & _visited(seg, 64, 64)  # [B, q, k]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
    p = torch.where(keep[:, None], torch.exp(logits - lse[..., None]), 0.0)
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * d ** -0.5
    np.testing.assert_allclose(dq.numpy(), want_dq.numpy(),
                               atol=1e-6 * float(want_dq.abs().max()))


def test_library_name_sees_included_headers(tmp_path):
    """A kernel's library is named by the hash of its source, of every
    header it includes with quotes and of the flags: editing the shared
    Hopper header renames the libraries of the sources that include it
    (K1, K2 and K3), so no stale build is loaded, and leaves the others
    alone."""
    csrc = REPO / "dinov3_tpu_torch" / "csrc"
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "layernorm_bwd")
    for name in (*names, "hopper"):
        suffix = ".cuh" if name == "hopper" else ".cu"
        shutil.copy(csrc / (name + suffix), tmp_path / (name + suffix))
    kernels = [CudaKernel(name, tmp_path / f"{name}.cu", []) for name in names]
    for kern in kernels[:3]:
        assert source_files(kern.source) == [kern.source, tmp_path / "hopper.cuh"]
    assert source_files(kernels[3].source) == [kernels[3].source]
    before = [kern.library for kern in kernels]
    assert before[2] == CudaKernel("flash_bwd_dkv", "flash_bwd_dkv.cu", []).library
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"// edited\n")
    after = [kern.library for kern in kernels]
    assert all(a != b for a, b in zip(after[:3], before[:3]))
    assert after[3] == before[3]
    header.write_bytes((csrc / "hopper.cuh").read_bytes())
    assert [kern.library for kern in kernels] == before


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_pack_visited_share_is_pinned():
    """The seeded mixed_ragged pack of ``chip_smoke.py`` (the port's own
    batcher, 4 x 2050 tokens): with K1's 64 x 64 bf16 tiles the schedule
    lists 1232 of the 4356 (q tile, key tile) pairs, 28.3 % (128 x 64
    tiles would list 29.9 %); the training student block's seg plane
    ([81, 197]) keeps 1080 of 1296, 83.3 % (88.9 %)."""
    from dinov3_tpu_torch.configs import load_config

    smoke = _load_chip_smoke()
    cfg = load_config(REPO / "configs" / "train" / "vitl16_im1k.yaml")
    assert FWD_TILES[torch.bfloat16] == (64, 64)
    for seg, want in (
            (smoke.serve_pack_seg(cfg), {(64, 64): (1232, 4356), (128, 64): (671, 2244)}),
            (smoke.train_attention_seg(), {(64, 64): (1080, 1296), (128, 64): (576, 648)})):
        for blocks, (listed, total) in want.items():
            tiles, counts = flash_tile_schedule_plain(torch.from_numpy(seg), *blocks)
            assert (int(counts.sum()), tiles.numel()) == (listed, total)


def test_dkv_walked_share_at_training_seg():
    """The share of (key tile, q tile) pairs K3 walks equals K1's share of
    (q tile, key tile) pairs: 1080 of 1296 (83.3 %) at the student block's
    seg plane of ``chip_smoke.py`` (B = 32, after a drop-path subset), and
    110 of 128 on the whole packed layout at B = 2."""
    from dinov3_tpu_torch.ops.packing import make_packed_layout, packed_segment_ids

    layout = make_packed_layout(n_global_rows=4, n_local=16, seq_global=197,
                                seq_local=37, n_prefix=1)
    for seg, want in ((_load_chip_smoke().train_attention_seg(), (1080, 1296)),
                      (packed_segment_ids(layout), (110, 128))):
        tiles, counts = flash_tile_schedule_plain(torch.from_numpy(seg))
        listed = dkv_tile_lists(tiles)
        assert (int(listed.sum()), listed.numel()) == want
        assert int(counts.sum()) == want[0]


@pytest.mark.parametrize("D,dtype,addresses,want", [
    (1, torch.bfloat16, (0, 16), 0),         # not a whole 16-byte vector
    (96, torch.bfloat16, (0, 16), 1),        # 12 vectors: one a lane
    (1000, torch.bfloat16, (0, 16), 4),      # 125 vectors
    (1024, torch.bfloat16, (0, 16), 4),      # the ViT-L width
    (1024, torch.float32, (0, 16), 8),
    (2048, torch.bfloat16, (0, 16), 8),      # the register cap
    (2048, torch.float32, (0, 16), 16),
    (4096, torch.bfloat16, (0, 16), 0),      # past the cap
    (1000, torch.float32, (0, 16), 8),
    (1024, torch.bfloat16, (0, 2), 0),       # a misaligned storage offset
    # K5's choice, from the addresses of x, g and dx
    (1024, torch.bfloat16, (0, 16, 32), 4),  # a student block's norm
    (1024, torch.bfloat16, (0, 16, 34), 0),  # dx misaligned
    (2048, torch.float32, (0, 16, 32), 16),
    (1001, torch.bfloat16, (0, 16, 32), 0),  # not whole vectors
])
def test_layernorm_path_choice(D, dtype, addresses, want):
    assert layernorm_vec_path(D, dtype, addresses) == want


def test_layernorm_path_choice_reads_storage_offsets():
    """A contiguous x that starts one element into its storage is not
    16-byte aligned and takes the general path."""
    base = torch.zeros(4 * 1024 + 1, dtype=torch.bfloat16)
    x = base[1:].view(4, 1024)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    assert layernorm_vec_path(1024, x.dtype, (x.data_ptr(),)) == 0
    assert layernorm_vec_path(1024, x.dtype, (base.data_ptr(),)) == 4


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


@pytest.mark.parametrize("B,N,h,d,n_seg", [
    (2, 128, 2, 64, 0),     # aligned, no segments
    (2, 97, 2, 32, 3),      # ragged N with segment ids and a -1 pad tail
    (1, 300, 2, 64, 5),     # several key blocks, segments
])
def test_attention_bwd_plain_matches_jax_pallas_vjp(B, N, h, d, n_seg):
    """K2 and K3's plain version against ``jax.vjp`` of the Pallas flash
    kernel (interpret mode), fp32, at the reference's own gradient
    tolerance 5e-5."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(N + 2, B, N, h, d)
    seg = _seg(N + 3, B, N, n_seg) if n_seg else None
    ct = np.random.default_rng(N + 4).standard_normal(q.shape).astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, interpret=True,
                                                  seg=jseg),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = attention_plain(tq, tk, tv, tseg)
    np.testing.assert_allclose(_to_np(o), np.asarray(out), atol=2e-5)
    got = attention_bwd_plain(tq, tk, tv, o, lse, torch.from_numpy(ct), tseg)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (B, N, h, d) and g.dtype == torch.float32
        np.testing.assert_allclose(_to_np(g), np.asarray(w), atol=5e-5,
                                   rtol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [(300, 128), (2, 7, 96), (33, 1024)])
def test_layernorm_bwd_plain_matches_jax_pallas_vjp(shape):
    """K5's plain version against ``jax.vjp`` of the Pallas LayerNorm
    (``force=True``, interpret mode), fp32: dx at 1e-5, dscale and dbias
    at 1e-5 of their magnitude (row sums in another order)."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.ops.fused_norm import fused_layernorm as jax_ln

    rng = np.random.default_rng(shape[0])
    D = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    s = (rng.standard_normal(D) * 0.5 + 1).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, c, e: jax_ln(a, c, e, 1e-6, interpret=True,
                                            force=True),
                     jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    wdx, wds, wdb = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    dx, ds, db = layernorm_bwd_plain(torch.from_numpy(x), torch.from_numpy(s),
                                     torch.from_numpy(g))
    assert dx.shape == shape and ds.shape == db.shape == (D,)
    np.testing.assert_allclose(_to_np(dx), wdx, atol=1e-5, rtol=1e-5)
    for got, want in ((ds, wds), (db, wdb)):
        np.testing.assert_allclose(_to_np(got), want,
                                   atol=1e-5 * np.abs(want).max(), rtol=1e-5)


@pytest.mark.parametrize("with_seg", [False, True])
def test_autograd_functions_pass_gradcheck_fp64(with_seg):
    """The autograd Functions around K1-K3 and K4-K5, on CPU tensors
    (their plain versions), against finite differences in fp64."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 9, 2, 4, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    seg = (torch.tensor([[0, 0, 0, 1, 1, 1, 1, -1, -1], [0] * 9],
                        dtype=torch.int32) if with_seg else None)
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, seg)[0], (q, k, v))
    x = torch.randn(3, 5, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    s, b = (torch.randn(8, generator=g, dtype=torch.float64,
                        requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(fused_layernorm, (x, s, b))


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
@pytest.mark.parametrize("kind", ["shuffled", "allpad", "wide"])
def test_flash_kernel_walks_schedule_matches_plain(cuda_device, kind):
    """K1 at the serve shape ([4 x 16, 2050, 64] bf16, v a view of the
    fused qkv output) with shuffled ids, an all-pad row, or ids spread over
    the int32 range, against the plain version (tolerances as above); two
    runs give the same bits."""
    B, N, h, d = 4, 2050, 16, 64
    q, k, v = (torch.from_numpy(t).to(cuda_device, torch.bfloat16)
               for t in _qkv(N, B, N, h, d))
    fused = torch.cat([q, k, v], dim=2).reshape(B, N, 3 * h * d)
    v = fused[..., 2 * h * d:].reshape(B, N, h, d)
    seg = torch.from_numpy(_seg_kind(kind, N, B, N)).to(cuda_device)
    out, lse = flash_attention(q, k, v, seg)
    again, _ = flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    want, want_lse = attention_plain(q, k, v, seg)
    np.testing.assert_allclose(_to_np(out), _to_np(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(_to_np(lse), _to_np(want_lse), atol=2e-1, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["runs", "shuffled", "wide", "allpad"])
@pytest.mark.parametrize("N,blocks", [(2050, (64, 64)), (197, (64, 64)),
                                      (333, (64, 32)), (5, (16, 8))])
def test_tile_schedule_kernel_matches_plain_bitwise(cuda_device, kind, N, blocks):
    seg = torch.from_numpy(_seg_kind(kind, N + 1, 5, N))
    before = FLASH_TILE_SCHEDULE.launches
    got = flash_tile_schedule(seg.to(cuda_device), *blocks)
    torch.cuda.synchronize()
    assert FLASH_TILE_SCHEDULE.launches == before + 1
    for g, w in zip(got, flash_tile_schedule_plain(seg, *blocks)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,dtype,pdtype", [
    (8200, 1024, "bfloat16", "bfloat16"),   # serve shape
    (1000, 96, "bfloat16", "float32"),       # width below one CTA
    (37, 64, "float32", "float32"),
    (3, 4096, "float32", "bfloat16"),        # widest instance
    (15957, 1024, "bfloat16", "float32"),    # a student block's norm
    (1000, 96, "float32", "bfloat16"),
    (77, 1000, "bfloat16", "bfloat16"),      # 125 vectors a row
    (77, 1000, "float32", "float32"),
    (50, 2048, "bfloat16", "float32"),       # the vector path's cap
    (50, 2048, "float32", "float32"),
    (9, 4096, "bfloat16", "bfloat16"),       # the general path
    (9, 1001, "bfloat16", "float32"),        # not whole vectors
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
    """CUDA inputs a kernel does not take raise; nothing falls back to the
    plain versions, and empty grids launch nothing."""
    empty = torch.zeros(0, 8, 2, 64, device=cuda_device, requires_grad=True)
    before = (FLASH_FWD.launches, FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches)
    out, _ = flash_attention(empty, empty, empty)
    assert out.shape == empty.shape
    out.sum().backward()
    assert empty.grad.shape == empty.shape
    assert (FLASH_FWD.launches, FLASH_BWD_DQ.launches,
            FLASH_BWD_DKV.launches) == before  # empty grids launch nothing
    bad = torch.zeros(1, 8, 2, 32, device=cuda_device)  # no head_dim-32 kernel
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(bad, bad, bad)
    wide = torch.zeros(2, 8192, device=cuda_device)
    with pytest.raises(ValueError, match="widths"):
        fused_layernorm(wide, torch.ones(8192, device=cuda_device),
                        torch.zeros(8192, device=cuda_device))
    x = torch.zeros(4, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fused_layernorm(x, torch.ones(64, device=cuda_device),
                        torch.zeros(64, device=cuda_device))
    # K2's key-tile and K3's q-tile lists: a schedule of the wrong shape,
    # dtype or device, one given without seg, or one given to the fp32
    # kernels, raises before anything is launched
    q = torch.randn(2, 130, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    seg = torch.zeros(2, 130, dtype=torch.int32, device=cuda_device)
    out, lse, (tiles, counts) = flash_fwd(q, q, q, seg)
    _, delta = flash_bwd_dq(q, q, q, out, lse, q, seg, (tiles, counts))
    before = (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches,
              FLASH_TILE_SCHEDULE.launches)
    for bad in ((tiles[:, :2], counts), (tiles, counts[:1]),
                (tiles.long(), counts), (tiles.cpu(), counts)):
        with pytest.raises(ValueError, match="schedule"):
            flash_bwd_dq(q, q, q, out, lse, q, seg, bad)
        with pytest.raises(ValueError, match="schedule"):
            flash_bwd_dkv(q, q, q, lse, delta, q, seg, bad)
    with pytest.raises(ValueError, match="schedule"):
        flash_bwd_dq(q, q, q, out, lse, q, None, (tiles, counts))
    qf, of = q.float(), out.float()
    with pytest.raises(ValueError, match="schedule"):
        flash_bwd_dq(qf, qf, qf, of, lse, qf, seg, (tiles, counts))
    with pytest.raises(ValueError, match="schedule"):
        flash_bwd_dkv(qf, qf, qf, lse, delta, qf, seg, (tiles, counts))
    assert (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches,
            FLASH_TILE_SCHEDULE.launches) == before


def _bwd_tol(want: np.ndarray, dtype) -> float:
    mag = max(float(np.abs(want).max()), 1e-6)
    return (2.0 ** -6 if dtype == torch.bfloat16 else 1e-4) * mag


def _bwd_seg(kind, B, N):
    """[B, N] int32 ids for the backward cases: None, ``packed`` (the
    student block's plane of ``chip_smoke.py``, B = 81, N = 197), 5 sorted
    ``runs`` with a pad tail, or a schedule kind of ``_seg_kind``."""
    if kind is None:
        return None
    if kind == "packed":
        seg = _load_chip_smoke().train_attention_seg()
        assert seg.shape == (B, N)
        return seg
    if kind == "runs5":
        return _seg(N, B, N, 5)
    return _seg_kind(kind, N + 2, B, N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,h,d,dtype,seg_kind,v_view", [
    (81, 197, 16, 64, "bfloat16", "runs5", True),   # the training shape, v a view
    (81, 197, 16, 64, "bfloat16", "packed", True),  # ... with the packed ids
    (2, 201, 3, 64, "bfloat16", None, False),       # ragged, no segments
    (3, 201, 4, 64, "bfloat16", "shuffled", True),  # ragged N = 201, K3 skips
    (3, 201, 4, 64, "bfloat16", "allpad", False),   # a row of pad tokens only
    (3, 201, 4, 64, "bfloat16", "wide", False),     # ids over the int32 range
    (2, 64, 2, 64, "bfloat16", "shuffled", False),  # one whole tile
    (2, 5, 2, 64, "bfloat16", "runs", False),       # less than a tile
    (1, 130, 2, 128, "bfloat16", "runs5", False),   # head_dim 128
    (2, 97, 2, 64, "float32", "runs5", True),
    (1, 200, 2, 128, "float32", None, False),
])
def test_flash_bwd_kernels_match_plain(cuda_device, B, N, h, d, dtype, seg_kind,
                                       v_view):
    """K2 and K3 through the autograd Function (both walking the forward's
    tile schedule where they read one: the backward launches no schedule
    kernel of its own) against the plain backward on the same inputs and
    the kernels' own O and LSE; two runs give the same bits (no atomics)."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(t).to(cuda_device, dt)
               for t in _qkv(N + 5, B, N, h, d))
    if v_view:
        fused = torch.cat([q, k, v], dim=2).reshape(B, N, 3 * h * d)
        v = fused[..., 2 * h * d:].reshape(B, N, h, d)
        assert not v.is_contiguous()
    seg = _bwd_seg(seg_kind, B, N)
    seg = None if seg is None else torch.from_numpy(seg).to(cuda_device)
    ct = torch.from_numpy(_qkv(N + 6, B, N, h, d)[0]).to(cuda_device, dt)
    grads = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches,
                  FLASH_TILE_SCHEDULE.launches)
        out, lse = flash_attention(*leaves, seg)
        (out.float() * ct.float()).sum().backward()
        torch.cuda.synchronize()
        assert (FLASH_BWD_DQ.launches, FLASH_BWD_DKV.launches,
                FLASH_TILE_SCHEDULE.launches) == (before[0] + 1, before[1] + 1, before[2])
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    want = attention_bwd_plain(q, k, v, out.detach(), lse, ct, seg)
    for name, got, w in zip("qkv", grads[0], want):
        assert got.dtype == dt and got.shape == q.shape
        w = _to_np(w)
        np.testing.assert_allclose(_to_np(got), w, atol=_bwd_tol(w, dt),
                                   err_msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("R,D,dtype,pdtype", [
    (22852, 1024, "bfloat16", "float32"),   # all packed student rows
    (15957, 1024, "bfloat16", "float32"),   # a student block's norm
    (1000, 96, "bfloat16", "float32"),       # width below one CTA
    (37, 64, "float32", "float32"),
    (3, 4096, "float32", "bfloat16"),        # widest instance
    (77, 1000, "bfloat16", "bfloat16"),      # 125 vectors a row
    (77, 1000, "float32", "float32"),
    (100, 1024, "bfloat16", "bfloat16"),     # fewer rows than CTAs
    (100, 1024, "float32", "bfloat16"),
    (50, 2048, "bfloat16", "float32"),       # sums in shared memory
    (50, 2048, "float32", "float32"),
    (9, 4096, "bfloat16", "bfloat16"),       # the general path
    (9, 1001, "bfloat16", "float32"),        # not whole vectors
])
def test_layernorm_bwd_kernel_matches_plain(cuda_device, R, D, dtype, pdtype):
    """K5 through the autograd Function against the plain backward, on its
    vector path and its general path; two runs give the same bits."""
    g = torch.Generator().manual_seed(R)
    x = (torch.randn(R, D, generator=g) * 3 + 1).to(cuda_device, getattr(torch, dtype))
    s = (torch.randn(D, generator=g) * 0.5 + 1).to(cuda_device, getattr(torch, pdtype))
    dy = torch.randn(R, D, generator=g).to(cuda_device, getattr(torch, dtype))
    runs = []
    for _ in range(2):
        xs = x.clone().requires_grad_()
        ss = s.clone().requires_grad_()
        bs = torch.zeros_like(s, requires_grad=True)
        before = LAYERNORM_BWD.launches
        fused_layernorm(xs, ss, bs).backward(dy)
        torch.cuda.synchronize()
        assert LAYERNORM_BWD.launches == before + 1
        runs.append((xs.grad, ss.grad, bs.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    dx, ds, db = runs[0]
    wdx, wds, wdb = (_to_np(t) for t in layernorm_bwd_plain(x, s, dy))
    assert dx.dtype == x.dtype and ds.dtype == db.dtype == s.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_to_np(dx), wdx, atol=1e-5, rtol=1e-5)
    else:
        row = np.abs(wdx).max(axis=-1, keepdims=True)
        err = np.abs(_to_np(dx) - wdx)
        assert (err <= bf16_ulp(wdx) + 2.0 ** -8 * row).all(), err.max()
    for got, want in ((ds, wds), (db, wdb)):
        tol = 1e-4 * np.abs(want).max()
        if pdtype == "bfloat16":
            tol += float(bf16_ulp(np.abs(want).max()))
        np.testing.assert_allclose(_to_np(got), want, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["blocks", "full"])
def test_student_block_under_remat_relaunches_k1_k4_and_keeps_grads(cuda_device, mode):
    """One ViT-L student block (width 1024, 16 heads, bf16 compute, fp32
    masters) on packed rows with segment ids, under activation
    checkpointing: the backward launches K1 once more and K4 twice more
    (the recompute), and every gradient is the no-remat block's, bit for
    bit (the same kernels on the same inputs)."""
    from dinov3_tpu_torch.ops.block import SelfAttentionBlock, remat_forward

    torch.manual_seed(0)
    blk = SelfAttentionBlock(1024, 16, layerscale_init=1.0,
                             dtype=torch.bfloat16).to(cuda_device)
    R, N = 8, 197
    x0 = torch.randn(R, N, 1024, device=cuda_device)
    seg = torch.from_numpy(_seg(N, R, N, 3)).to(cuda_device)
    runs = {}
    for m in ("none", mode):
        x = x0.clone().requires_grad_()
        before = {k: kern.launches for k, kern in
                  (("K1", FLASH_FWD), ("K4", LAYERNORM_FWD), ("K2", FLASH_BWD_DQ))}
        out = remat_forward(blk, m)(x, seg=seg)
        fwd = {"K1": FLASH_FWD.launches - before["K1"],
               "K4": LAYERNORM_FWD.launches - before["K4"]}
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        runs[m] = ({"K1": FLASH_FWD.launches - before["K1"],
                    "K4": LAYERNORM_FWD.launches - before["K4"],
                    "K2": FLASH_BWD_DQ.launches - before["K2"]}, fwd,
                   [x.grad] + [p.grad.clone() for p in blk.parameters()])
        blk.zero_grad(set_to_none=True)
    assert runs["none"][1] == runs[mode][1] == {"K1": 1, "K4": 2}
    assert runs["none"][0] == {"K1": 1, "K4": 2, "K2": 1}
    assert runs[mode][0] == {"K1": 2, "K4": 4, "K2": 1}
    for a, b in zip(runs[mode][2], runs["none"][2]):
        assert torch.equal(a, b)
