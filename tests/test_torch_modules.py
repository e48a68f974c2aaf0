"""The port's layers and backbone against the JAX modules, on the same
numpy inputs and bridged weights (``interop/from_jax.py``), fp32, at
``vit_test`` size. The JAX attention runs the Pallas flash kernel in
interpret mode (``attn_impl="pallas"``), as the port's attention always
runs kernel K1 (here its plain version).

Tolerances: 1e-5 for single layers and 1e-4 for whole-model features
(fp32; the two sides sum in other orders and scale attention logits at
another point, which moves values by a few ulps per layer).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinov3_tpu_torch.interop import state_dict_from_jax

D, H = 64, 2


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    """The JAX side reads the process's current mesh (another test's
    ``build_train_setup`` may have left an 8-device one): a drop-path
    plan, the packed row order and the sharding constraints then follow
    that mesh. These single-device comparisons run without one."""
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


def _noisy(params, seed):
    """Perturb every leaf so zero-initialised biases and tokens count."""
    leaves, tree = jax.tree.flatten(nn.meta.unbox(params))
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])


def _block_weights(module_params, prefix):
    """Bridge one block-level JAX module's params through the block key
    table: returns the port's keys under ``blocks.0.<prefix>.``."""
    sd = state_dict_from_jax({"blocks_0": {prefix: module_params}})
    head = f"blocks.0.{prefix}."
    return {k[len(head):]: v for k, v in sd.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _seg_rows(B, N):
    seg = np.full((B, N), -1, np.int32)
    seg[:, : N // 3] = 0
    seg[:, N // 3: N - 3] = 1
    return seg


# ---------------- RoPE ----------------

def test_rope_tables_and_apply_match_jax():
    from dinov3_tpu.ops import rope as jr

    from dinov3_tpu_torch.ops import rope as tr

    hd = D // H
    jp = jr.rope_periods(hd, base=100.0)
    tp = tr.rope_periods(hd, base=100.0)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    for mode in ("separate", "max", "min"):
        np.testing.assert_array_equal(
            tr.patch_coords(3, 5, mode).numpy(),
            np.asarray(jr.patch_coords(3, 5, mode)))
    js, jc = jr.rope_with_identity_prefix(*jr.rope_sincos(3, 5, jp), 3)
    ts, tc = tr.rope_with_identity_prefix(*tr.rope_sincos(3, 5, tp), 3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    q, k = _x(0, 2, 18, H, hd), _x(1, 2, 18, H, hd)
    table3 = _x(2, 2, 18, hd), _x(3, 2, 18, hd)  # per-row tables
    for sin, cos in ((np.asarray(js), np.asarray(jc)), table3):
        jq, jk = jr.rope_apply_full(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(sin), jnp.asarray(cos))
        tq, tk = tr.rope_apply_full(*(torch.from_numpy(np.array(a))
                                      for a in (q, k, sin, cos)))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)


# ---------------- layers ----------------

def test_patch_embed_matches_jax_on_images_and_host_patches():
    from dinov3_tpu.ops.patch_embed import PatchEmbed as JPatchEmbed
    from dinov3_tpu.serve.batcher import patchify

    from dinov3_tpu_torch.ops.patch_embed import PatchEmbed

    img = _x(4, 2, 12, 8, 3)
    jm = JPatchEmbed(embed_dim=D, patch_size=4, dtype=jnp.float32)
    params = _noisy(jm.init(jax.random.key(0), jnp.asarray(img))["params"], 5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(img)))
    tm = PatchEmbed(D, patch_size=4, dtype=torch.float32)
    sd = state_dict_from_jax({"patch_embed": params})
    tm.load_state_dict({k[len("patch_embed."):]: v for k, v in sd.items()})
    got = tm(torch.from_numpy(img)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # host-patchified pixels embed to the same tokens
    patches = np.stack([patchify(im, 4) for im in img])
    got_p = tm.embed_patches(torch.from_numpy(patches)).detach().numpy()
    np.testing.assert_allclose(got_p, want, atol=1e-5)


def test_mlp_matches_jax():
    from dinov3_tpu.ops.ffn import Mlp as JMlp

    from dinov3_tpu_torch.ops.ffn import Mlp, make_ffn_layer

    x = _x(6, 2, 9, D)
    jm = JMlp(hidden_dim=2 * D, dtype=jnp.float32)
    params = _noisy(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 7)
    tm = Mlp(D, 2 * D, dtype=torch.float32)
    tm.load_state_dict(_block_weights(params, "mlp"))
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply({"params": params}, jnp.asarray(x))), atol=1e-5)
    with pytest.raises(NotImplementedError, match="not ported"):
        make_ffn_layer("moe", D, 2 * D)


@pytest.mark.parametrize("with_seg,mask_k_bias", [(False, False), (True, True)])
def test_attention_matches_jax(with_seg, mask_k_bias):
    from dinov3_tpu.ops.attention import SelfAttention as JAttn

    from dinov3_tpu_torch.ops.attention import SelfAttention

    B, N, hd = 2, 21, D // H
    x = _x(8, B, N, D)
    sin, cos = np.sin(_x(9, B, N, hd)), np.cos(_x(9, B, N, hd))
    seg = _seg_rows(B, N) if with_seg else None
    jm = JAttn(dim=D, num_heads=H, mask_k_bias=mask_k_bias,
               attn_impl="pallas", dtype=jnp.float32)
    args = (jnp.asarray(x), (jnp.asarray(sin), jnp.asarray(cos)))
    jseg = None if seg is None else jnp.asarray(seg)
    params = _noisy(jm.init(jax.random.key(0), *args, seg=jseg)["params"], 10)
    want = np.asarray(jm.apply({"params": params}, *args, seg=jseg))
    tm = SelfAttention(D, H, mask_k_bias=mask_k_bias, dtype=torch.float32)
    tm.load_state_dict(_block_weights(params, "attn"))
    got = tm(torch.from_numpy(x), rope=(torch.from_numpy(sin),
                                        torch.from_numpy(cos)),
             seg=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


def test_block_matches_jax():
    from dinov3_tpu.ops.block import SelfAttentionBlock as JBlock

    from dinov3_tpu_torch.ops.block import SelfAttentionBlock

    B, N, hd = 2, 21, D // H
    x = _x(11, B, N, D)
    rope = (np.sin(_x(12, N, hd)), np.cos(_x(12, N, hd)))
    seg = _seg_rows(B, N)
    jm = JBlock(dim=D, num_heads=H, ffn_ratio=2.0, layerscale_init=0.1,
                attn_impl="pallas", dtype=jnp.float32)
    jargs = (jnp.asarray(x), tuple(jnp.asarray(t) for t in rope), True,
             None, jnp.asarray(seg))
    params = _noisy(jm.init(jax.random.key(0), *jargs)["params"], 13)
    want = np.asarray(jm.apply({"params": params}, *jargs))
    tm = SelfAttentionBlock(D, H, ffn_ratio=2.0, layerscale_init=0.1,
                            dtype=torch.float32)
    sd = state_dict_from_jax({"blocks_0": params})
    tm.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()})
    got = tm(torch.from_numpy(x), rope=tuple(torch.from_numpy(t) for t in rope),
             seg=torch.from_numpy(seg))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)


# ---------------- the backbone ----------------

BACKBONE = ["student.arch=vit_test", "student.patch_size=4",
            "compute_precision.compute_dtype=fp32",
            "kernels.flash_attention=pallas"]


def _pair(overrides, seed=0):
    """(JAX model, noisy params, port model with the bridged weights)."""
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu.models import build_backbone as jax_build

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default
    from dinov3_tpu_torch.models import build_backbone

    cfg = get_default_config()
    apply_dot_overrides(cfg, overrides)
    tcfg = t_default()
    t_apply(tcfg, overrides)
    jm = jax_build(cfg, teacher=True)
    params = nn.meta.unbox(
        jm.init(jax.random.key(seed), jnp.zeros((1, 16, 16, 3))))["params"]
    params = _noisy(params, seed + 1)
    tm = build_backbone(tcfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("extra", [
    [],
    ["student.n_storage_tokens=2", "student.untie_cls_and_patch_norms=true",
     "student.mask_k_bias=true"],
])
def test_backbone_call_matches_jax(extra):
    jm, params, tm = _pair(BACKBONE + extra)
    x = _x(14, 2, 16, 12, 3)
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    for key in ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens",
                "x_prenorm"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)


def test_build_backbone_is_seeded_and_refuses_what_is_not_ported():
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.models import build_backbone

    cfg = get_default_config()
    apply_dot_overrides(cfg, ["student.arch=vit_test", "student.patch_size=4"])
    a, b = (build_backbone(cfg, device="cpu", seed=3) for _ in range(2))
    c = build_backbone(cfg, device="cpu", seed=4)
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.cls_token, c.cls_token)
    assert a.cls_token.dtype == torch.float32  # param_dtype fp32
    assert a.dtype == torch.bfloat16           # compute_dtype bf16
    for bad, err in (("student.arch=convnext_tiny", NotImplementedError),
                     ("student.arch=vit_nope", ValueError),
                     ("student.ffn_layer=moe", NotImplementedError)):
        cfg2 = get_default_config()
        apply_dot_overrides(cfg2, ["student.arch=vit_test", bad])
        with pytest.raises(err):
            build_backbone(cfg2, device="cpu")


# ---------------- the training slice's layers ----------------

def _layout(n_local):
    from dinov3_tpu.ops.packing import make_packed_layout as jlay

    from dinov3_tpu_torch.ops.packing import make_packed_layout

    kw = dict(n_global_rows=4, n_local=n_local, seq_global=17, seq_local=5,
              n_prefix=1)
    return jlay(**kw), make_packed_layout(**kw)


@pytest.mark.parametrize("n_local", [8, 9])  # ragged last row, full rows
def test_packing_matches_jax(n_local):
    from dinov3_tpu.ops import packing as jp

    from dinov3_tpu_torch.ops import packing as tp

    jl, tl = _layout(n_local)
    for a in ("k", "n_packed_rows", "rows_total", "pad_segments",
              "pad_tokens_per_row"):
        assert getattr(tl, a) == getattr(jl, a), a
    np.testing.assert_array_equal(tp.packed_segment_ids(tl),
                                  jp.packed_segment_ids(jl))
    loc, glob = _x(20, n_local, 5, D), _x(21, 4, 17, D)
    jrows = jp.assemble_packed_batch(
        jnp.asarray(glob), jp.pack_local_rows(jnp.asarray(loc), jl), jl)
    trows = torch.cat([torch.from_numpy(glob),
                       tp.pack_local_rows(torch.from_numpy(loc), tl)])
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    for a, b in zip(tp.split_packed_output(trows, tl),
                    jp.split_packed_output(jrows, jl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rope_packed_rows_matches_jax():
    from dinov3_tpu.ops import rope as jr

    from dinov3_tpu_torch.ops import rope as tr

    jl, tl = _layout(9)
    hd = D // H
    tables = []
    for mod, lib in ((jr, jnp), (tr, torch)):
        p = mod.rope_periods(hd, base=100.0)
        tables.append(mod.rope_packed_rows(
            mod.rope_with_identity_prefix(*mod.rope_sincos(4, 4, p), 1),
            mod.rope_with_identity_prefix(*mod.rope_sincos(2, 2, p), 1),
            jl if mod is jr else tl))
    for want, got in zip(*tables):
        assert tuple(got.shape) == (tl.rows_total, 17, hd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kind", ["subset", "mask"])
def test_planned_drop_path_residuals_match_jax(kind):
    """A branch that reads per-row context (a table and segment-like ids)
    under the planned residuals: the port gathers the context with the
    kept rows as JAX does."""
    from dinov3_tpu.ops import drop_path as jd

    from dinov3_tpu_torch.ops import drop_path as td

    x, w = _x(22, 7, 5, D), _x(23, D, D) * 0.1
    table, ids = _x(24, 7, 5, D), np.arange(7 * 5).reshape(7, 5).astype(np.int32)

    def branch(lib, t, aux=None):
        tab = table if aux is None else aux["rope"][0]
        idv = ids if aux is None else aux["seg"]
        return lib.tanh(t @ w) * tab + idv[..., None] * 1e-3

    aux_j = {"rope": (jnp.asarray(table),), "seg": jnp.asarray(ids)}
    aux_t = {"rope": (torch.from_numpy(table),), "seg": torch.from_numpy(ids)}
    if kind == "subset":
        idx = np.array([0, 2, 3, 6], np.int32)
        want = jd.subset_residual_planned(
            jnp.asarray(x), lambda t, a: branch(jnp, t, a), jnp.asarray(idx),
            aux=aux_j)
        got = td.subset_residual_planned(
            torch.from_numpy(x), lambda t, a: branch(torch, t, a),
            torch.from_numpy(idx).long(), aux=aux_t)
    else:
        bits = np.array([1, 0, 1, 1, 0, 0, 1], bool)
        want = jd.mask_residual_planned(
            jnp.asarray(x), branch(jnp, jnp.asarray(x)), jnp.asarray(bits), 0.3)
        got = td.mask_residual_planned(
            torch.from_numpy(x), branch(torch, torch.from_numpy(x)),
            torch.from_numpy(bits), 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert td.subset_keep_count(116, 0.3) == jd.subset_keep_count(116, 0.3) == 81
    assert td.resolve_drop_path(116, 0.3, "subset") == "subset"
    assert td.resolve_drop_path(1, 0.3, "subset") == "mask"  # keeps every row
    assert td.resolve_drop_path(116, 0.3, "mask") == "mask"


def test_train_block_with_plan_matches_jax():
    """The block's training call on the packed batch: subset drop path
    from a plan slice, per-row RoPE tables and segment ids gathered with
    the kept rows, values and gradients."""
    from dinov3_tpu.ops.block import SelfAttentionBlock as JBlock

    from dinov3_tpu_torch.ops.block import SelfAttentionBlock

    Bn, N, hd = 5, 21, D // H
    x = _x(25, Bn, N, D)
    rope = (np.sin(_x(26, Bn, N, hd)), np.cos(_x(26, Bn, N, hd)))
    seg = np.stack([_seg_rows(1, N)[0]] * 2 + [np.zeros(N, np.int32)] * 3)
    idx = np.array([[0, 1, 3], [1, 2, 4]], np.int32)
    jm = JBlock(dim=D, num_heads=H, ffn_ratio=2.0, layerscale_init=0.1,
                drop_path_rate=0.4, attn_impl="pallas", dtype=jnp.float32)
    jrope = tuple(jnp.asarray(t) for t in rope)
    params = _noisy(jm.init(jax.random.key(0), jnp.asarray(x), jrope, True,
                            None, jnp.asarray(seg))["params"], 27)

    def jloss(p, xx):
        y = jm.apply({"params": p}, xx, jrope, False, {"idx": jnp.asarray(idx)},
                     jnp.asarray(seg))
        return jnp.sum(y * jnp.asarray(x)), y

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm = SelfAttentionBlock(D, H, ffn_ratio=2.0, layerscale_init=0.1,
                            drop_path_rate=0.4, dtype=torch.float32)
    sd = state_dict_from_jax({"blocks_0": params})
    tm.load_state_dict({k[len("blocks.0."):]: v for k, v in sd.items()})
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx, rope=tuple(torch.from_numpy(t) for t in rope),
             seg=torch.from_numpy(seg), plan={"idx": torch.from_numpy(idx).long()})
    (got * torch.from_numpy(x)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-4)
    gsd = state_dict_from_jax({"blocks_0": jax.tree.map(np.asarray, gp)})
    for n, p in tm.named_parameters():
        w = gsd[f"blocks.0.{n}"].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=n)


def test_packed_train_forward_matches_jax():
    """The ViT's crop-packed training forward (mask token on the global
    crops, locals packed k to a row, the plan's subset drop path) against
    JAX ``_packed_forward`` with the same plan."""
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu.models import build_backbone as jax_build

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default
    from dinov3_tpu_torch.models import ARCHS, backbone_kwargs_from_cfg
    from dinov3_tpu_torch.rng import plan_to_device

    overrides = BACKBONE + ["student.drop_path_rate=0.3"]
    _, params, _ = _pair(overrides, seed=3)  # the teacher's tree is the student's
    cfg = get_default_config()
    apply_dot_overrides(cfg, overrides)
    js = jax_build(cfg, teacher=False)
    tcfg = t_default()
    t_apply(tcfg, overrides)
    ts = ARCHS["vit_test"](**backbone_kwargs_from_cfg(tcfg, teacher=False))
    ts.load_state_dict(state_dict_from_jax(params))
    g, loc = _x(28, 4, 16, 16, 3), _x(29, 8, 8, 8, 3)
    masks = np.random.default_rng(30).random((4, 16)) < 0.3
    rng = np.random.default_rng(31)
    rows = 4 + 3  # 2B globals + ceil(8 / 3) packed rows
    idx = np.sort(np.stack([[rng.permutation(rows)[:4] for _ in range(2)]
                            for _ in range(2)]), axis=-1).astype(np.int32)
    plan = {"drop_path": {"idx": idx}}
    want = js.apply({"params": params}, jnp.asarray(g), jnp.asarray(masks),
                    deterministic=False, local_crops=jnp.asarray(loc),
                    rng_plan={"drop_path": {"idx": jnp.asarray(idx)}})
    got = ts(torch.from_numpy(g), torch.from_numpy(masks), train=True,
             plan=plan_to_device(plan, "cpu"), local_crops=torch.from_numpy(loc))
    for key in ("x_norm_clstoken", "x_norm_patchtokens", "x_prenorm",
                "local_cls"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), atol=1e-4, err_msg=key)
    with pytest.raises(ValueError, match="plan"):
        ts(torch.from_numpy(g), train=True, local_crops=torch.from_numpy(loc))
