"""The ViT-g/14 recipe's model pieces in the port against the JAX package,
fp32 on the CPU at ``vit_test`` width: SwiGLU, a SwiGLU ViT with patch 14
and 4 storage tokens, RoPE coordinate augmentation, the two-pass student
(``model.crop_packing=false``) and ``rng.plan=false``.

Inputs are made with numpy from a seed; weights are JAX's, perturbed and
bridged by ``interop/from_jax.py``; randomness (drop-path rows, RoPE
factors) is JAX's plan handed across as numpy, since the port's generators
are not threefry. The port's own draws are held to the reference's
statistics instead.

Tolerances:
- the augmentation factors and coordinates: 1e-6 relative (fp32 exp);
- one SwiGLU layer: 1e-5; a whole ViT's features: 1e-4 (the golden bound
  of ``tests/test_golden_parity.py`` is 1e-3; fp32 sums in other orders);
- the meta-arch's loss terms: 1e-5 relative, every student gradient leaf
  1e-4 of its largest magnitude (``tests/test_torch_train.py``'s bounds);
- the two-pass student against the packed one: the same bounds;
- the port's draws: exact keep counts and ranges, frequencies and means
  within 5 standard errors of the reference's distributions.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import _noisy, _x
from test_torch_train import LOSSES, _np, cfgs

from dinov3_tpu_torch.interop import meta_state_dicts_from_jax, state_dict_from_jax

B = 4
ROPE_AUG = ["student.pos_embed_rope_shift_coords=0.1",
            "student.pos_embed_rope_jitter_coords=1.2",
            "student.pos_embed_rope_rescale_coords=2.0"]


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


# ---------------- SwiGLU ----------------

@pytest.mark.parametrize("kind,hidden", [("swiglu", 100), ("swiglu64", 100),
                                         ("swiglu128", 200)])
def test_swiglu_ffn_matches_jax(kind, hidden):
    """All three alignments: the hidden width (2/3 rule, rounded up) and
    the output within 1e-5."""
    from dinov3_tpu.ops.ffn import make_ffn_layer as jax_ffn
    from dinov3_tpu.ops.ffn import swiglu_hidden_dim as jax_hidden

    from dinov3_tpu_torch.ops.ffn import SwiGLUFFN, make_ffn_layer, swiglu_hidden_dim

    D = 48
    x = _x(1, 3, 5, D)
    jm = jax_ffn(kind, hidden, dtype=jnp.float32)
    params = _noisy(jm.init(jax.random.key(0), jnp.asarray(x))["params"], 2)
    tm = make_ffn_layer(kind, D, hidden, dtype=torch.float32)
    assert isinstance(tm, SwiGLUFFN)
    align = {"swiglu": 8, "swiglu64": 64, "swiglu128": 128}[kind]
    assert tm.hidden == swiglu_hidden_dim(hidden, align) == jax_hidden(hidden, align)
    assert tm.hidden % align == 0 and params["w12"]["kernel"].shape == (D, 2 * tm.hidden)
    sd = state_dict_from_jax({"blocks_0": {"mlp": params}})
    tm.load_state_dict({k[len("blocks.0.mlp."):]: v for k, v in sd.items()})
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply({"params": params}, jnp.asarray(x))),
                               atol=1e-5)


def test_vit_giant2_hidden_width_is_4096():
    from dinov3_tpu_torch.models.vision_transformer import vit_giant2

    with torch.device("meta"):
        m = vit_giant2(patch_size=14, ffn_layer="swiglu", n_storage_tokens=4)
    assert m.blocks[0].mlp.hidden == 4096 and m.head_dim == 64 and m.n_blocks == 40
    assert tuple(m.blocks[0].mlp.w12.weight.shape) == (8192, 1536)


SWIGLU_VIT = ["student.arch=vit_test", "student.patch_size=14",
              "student.n_storage_tokens=4", "student.ffn_layer=swiglu",
              "student.mask_k_bias=true", "compute_precision.compute_dtype=fp32",
              "kernels.flash_attention=pallas"]


def _swiglu_pair(extra=(), seed=0, teacher=True):
    """(JAX model, noisy params, port model with the bridged weights) of a
    2-block SwiGLU ViT, patch 14, 4 storage tokens."""
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu.models import build_backbone as jax_build

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default
    from dinov3_tpu_torch.models import ARCHS, backbone_kwargs_from_cfg

    overrides = SWIGLU_VIT + list(extra)
    cfg = get_default_config()
    apply_dot_overrides(cfg, overrides)
    tcfg = t_default()
    t_apply(tcfg, overrides)
    jm = jax_build(cfg, teacher=teacher)
    import flax.linen as nn

    params = nn.meta.unbox(jm.init(jax.random.key(seed),
                                   jnp.zeros((1, 28, 28, 3))))["params"]
    params = _noisy(params, seed + 1)
    tm = ARCHS["vit_test"](**backbone_kwargs_from_cfg(tcfg, teacher=teacher))
    tm.float().load_state_dict(state_dict_from_jax(params))
    return jm, params, tm


def test_swiglu_vit_builds_the_jax_tree_and_matches_its_features():
    """Patch 14, 4 storage tokens and SwiGLU give the JAX parameter tree
    name for name and shape for shape; features within 1e-4."""
    jm, params, tm = _swiglu_pair()
    bridged = state_dict_from_jax(params)
    assert bridged.keys() == tm.state_dict().keys()
    assert all(tuple(bridged[k].shape) == tuple(v.shape) for k, v in tm.state_dict().items())
    assert "blocks.1.mlp.w12.weight" in bridged and "blocks.1.mlp.w3.bias" in bridged
    x = _x(3, 2, 28, 42, 3)
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    for key in ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens", "x_prenorm"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)


# ---------------- RoPE coordinate augmentation ----------------

@pytest.mark.parametrize("aug", [(0.1, 1.2, 2.0), (None, 1.5, None), (0.3, None, None),
                                 (None, None, 2.0)])
def test_rope_aug_values_and_planned_coords_match_jax(aug):
    from dinov3_tpu.ops import rope as jr

    from dinov3_tpu_torch.ops import rope as tr

    u = np.random.default_rng(4).random(5).astype(np.float32)
    want = jr.rope_aug_values(jnp.asarray(u), *aug)
    got = tr.rope_aug_values(torch.from_numpy(u), *aug)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)
    coords = jr.patch_coords(3, 5)
    np.testing.assert_allclose(
        tr.augment_coords_planned(tr.patch_coords(3, 5), got).numpy(),
        np.asarray(jr.augment_coords_planned(coords, want)), rtol=1e-6, atol=1e-7)
    periods = jr.rope_periods(32)
    js, jc = jr.rope_sincos(3, 5, periods, aug=want)
    ts, tc = tr.rope_sincos(3, 5, tr.rope_periods(32), aug=got)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def _jax_factors(seed, aug=(0.1, 1.2, 2.0)):
    from dinov3_tpu.ops.rope import rope_aug_values

    u = jax.random.uniform(jax.random.key(seed), (5,))
    return {k: np.asarray(v) for k, v in rope_aug_values(u, *aug).items()}


def test_rope_augmented_forwards_match_jax():
    """A training forward of one crop kind, and the packed forward with a
    factor set per crop kind, against JAX with the same factors; a
    training forward without factors is refused, a deterministic one
    ignores the setting."""
    from dinov3_tpu_torch.rng import plan_to_device

    no_drop = ROPE_AUG + ["student.drop_path_rate=0.0"]
    jm, params, tm = _swiglu_pair(no_drop, seed=5, teacher=False)
    g, loc = _x(6, 4, 42, 42, 3), _x(7, 8, 14, 14, 3)  # 14 and 6 tokens: 2 a row
    fg, fl = _jax_factors(1), _jax_factors(2)
    want = jm.apply({"params": params}, jnp.asarray(g), deterministic=False,
                    rng_plan={"rope": fg})
    got = tm(torch.from_numpy(g), train=True, plan=plan_to_device({"rope": fg}, "cpu"))
    np.testing.assert_allclose(got["x_prenorm"].detach().numpy(),
                               np.asarray(want["x_prenorm"]), atol=1e-4)
    plain = tm(torch.from_numpy(g))["x_prenorm"].detach().numpy()
    assert np.abs(plain - np.asarray(want["x_prenorm"])).max() > 1e-3  # the factors count
    nested = {"rope": {"global": fg, "local": fl}}
    want = jm.apply({"params": params}, jnp.asarray(g), deterministic=False,
                    local_crops=jnp.asarray(loc), rng_plan=nested)
    got = tm(torch.from_numpy(g), train=True, plan=plan_to_device(nested, "cpu"),
             local_crops=torch.from_numpy(loc))
    for key in ("x_prenorm", "local_cls"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    with pytest.raises(ValueError, match="augmentation"):
        tm(torch.from_numpy(g), train=True)
    jt, tparams, tt = _swiglu_pair(no_drop, seed=5, teacher=True)
    assert tt.rope_aug is None  # the teacher never augments
    np.testing.assert_allclose(
        tt(torch.from_numpy(g))["x_prenorm"].detach().numpy(),
        np.asarray(jt.apply({"params": tparams}, jnp.asarray(g))["x_prenorm"]), atol=1e-4)


# ---------------- the port's plans ----------------

def test_step_plans_have_the_jax_plans_structure():
    """Packed and two-pass, the step plan and ``rng.plan=false``: the keys
    and shapes of JAX ``build_rng_plan``'s."""
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import SSLMetaArch

    for packing in ("true", "false"):
        jcfg, tcfg = cfgs(ROPE_AUG + [f"model.crop_packing={packing}"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmeta = JMeta(jcfg)
        batch = make_synthetic_batch(tcfg, B, seed=0)
        jplan = jmeta.build_rng_plan(jax.random.key(0),
                                     {k: jnp.asarray(v) for k, v in batch.items()})
        jplan = jplan["packed"] if packing == "true" else jplan
        meta = SSLMetaArch(tcfg)
        for plan_flag in (True, False):
            meta.rng_plan = plan_flag
            plan = meta.draw_plan(0, 3, batch)
            shapes = jax.tree.map(lambda a: tuple(np.shape(a)), jplan)
            assert jax.tree.map(lambda a: tuple(a.shape), plan) == shapes


def _reference_draws(n):
    """n draws of the reference: legacy ``augment_coords`` factors and
    ``subset_residual``'s permutations, from JAX keys."""
    from dinov3_tpu.ops.rope import augment_coords

    ones = jnp.ones((1, 2))
    shifts, jitters, rescales = [], [], []
    for i in range(n):
        key = jax.random.key(i)
        shifts.append(np.asarray(augment_coords(jnp.zeros((1, 2)), key, shift=0.1))[0])
        jitters.append(np.asarray(augment_coords(ones, key, jitter=1.2))[0])
        rescales.append(np.asarray(augment_coords(ones, key, rescale=2.0))[0, 0])
    return np.array(shifts), np.array(jitters), np.array(rescales)


def test_fold_in_plan_draws_have_the_reference_statistics():
    """``rng.plan=false`` and the step plan: every subset keeps
    floor(B (1 - rate)) sorted, unique rows, each row kept at the rate's
    frequency; mask bits keep at 1 - rate; the RoPE factors lie in the
    reference's ranges with its mean logs (uniform in log space), against
    draws of the JAX legacy ``augment_coords``. Each plan is a pure
    function of (seed, iteration)."""
    from dinov3_tpu_torch.rng import fold_in_plan, step_generator, step_plan

    rows, rate, n = 10, 0.3, 300
    rope = (0.1, 1.2, 2.0)
    kw = dict(n_blocks=2, rows={"global": rows, "local": 2 * rows}, rate=rate,
              rope_aug=rope)
    for draw in (lambda it: fold_in_plan(7, it, **kw),
                 lambda it: step_plan(step_generator(7, it), **kw)):
        plans = [draw(it) for it in range(n)]
        idx = np.stack([p["global"]["drop_path"]["idx"].numpy() for p in plans])
        assert idx.shape[-1] == int(rows * (1 - rate))
        assert (np.diff(idx, axis=-1) > 0).all() and idx.min() >= 0 and idx.max() < rows
        freq = np.bincount(idx.ravel(), minlength=rows) / (idx.size / idx.shape[-1])
        p = idx.shape[-1] / rows
        assert np.abs(freq - p).max() < 5 * np.sqrt(p * (1 - p) / (n * 4))
        f = {k: np.stack([pl[c]["rope"][k].numpy() for pl in plans for c in ("global", "local")])
             for k in ("shift", "jitter", "rescale")}
        shifts, jitters, rescales = _reference_draws(100)
        for got, want, lo, hi in ((f["shift"], shifts, -0.1, 0.1),
                                  (np.log(f["jitter"]), np.log(jitters), -np.log(1.2),
                                   np.log(1.2)),
                                  (np.log(f["rescale"]), np.log(rescales), -np.log(2.0),
                                   np.log(2.0))):
            assert got.min() >= lo and got.max() <= hi
            assert want.min() >= lo - 1e-6 and want.max() <= hi + 1e-6
            sd = (hi - lo) / np.sqrt(12)
            assert abs(got.mean() - (lo + hi) / 2) < 5 * sd / np.sqrt(got.size)
            assert abs(want.mean() - (lo + hi) / 2) < 5 * sd / np.sqrt(want.size)
        again = draw(5)
        assert all(torch.equal(a, b) for a, b in zip(
            jax.tree.leaves(again), jax.tree.leaves(plans[5])))
    # mask mode (a pass too small for subsetting): keep bits at 1 - rate
    keep = np.stack([fold_in_plan(1, it, n_blocks=3, rows={"packed": 40}, rate=rate,
                                  mode="mask")["drop_path"]["keep"].numpy()
                     for it in range(50)])
    assert abs(keep.mean() - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / keep.size)
    a = fold_in_plan(7, 0, **kw)["global"]["drop_path"]["idx"]
    b = step_plan(step_generator(7, 0), **kw)["global"]["drop_path"]["idx"]
    assert not torch.equal(a, b)  # two derivations, two draws


# ---------------- the two-pass student and rng.plan=false ----------------

def _meta_world(extra, seed=0):
    """The JAX meta-arch (perturbed weights) and the port's holding the same
    weights, with one batch."""
    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.train import SSLMetaArch

    jcfg, tcfg = cfgs(list(extra))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    batch = make_synthetic_batch(jcfg, B, seed=seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jmeta.init_params(jax.random.key(0), jbatch))
    from test_torch_train import _noisy as noisy

    params = {"student": noisy(params["student"], 1), "teacher": noisy(params["teacher"], 2)}
    tmeta = SSLMetaArch(tcfg)
    sds = meta_state_dicts_from_jax(params)
    tmeta.student.load_state_dict(sds["student"])
    tmeta.teacher.load_state_dict(sds["teacher"])
    return jmeta, tmeta, params, batch, jbatch


def _jax_losses_and_grads(jmeta, params, jbatch, plan):
    def loss(student):
        total, (d, _) = jmeta.forward(
            student, {"teacher": params["teacher"]}, jbatch, teacher_temp=0.07,
            state=jmeta.init_state(), iteration=jnp.asarray(0, jnp.int32), rng_plan=plan)
        return total, d

    (_, d), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params["student"])
    return ({k: float(v) for k, v in d.items()},
            meta_state_dicts_from_jax({"g": jax.tree.map(np.asarray, grads)})["g"])


def _port_losses_and_grads(tmeta, batch, plan):
    from dinov3_tpu_torch.rng import plan_to_device
    from dinov3_tpu_torch.train import put_batch

    tmeta.student.zero_grad(set_to_none=True)
    total, d, _ = tmeta(put_batch(batch, "cpu"), teacher_temp=0.07,
                        plan=plan_to_device(plan, "cpu"))
    total.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
             for n, p in tmeta.student.named_parameters()}
    tmeta.student.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in d.items()}, grads


def _assert_close(got, want, gg, wg):
    for k in LOSSES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for n, w in wg.items():
        w = np.asarray(w.numpy() if torch.is_tensor(w) else w)
        np.testing.assert_allclose(_np(gg[n]), w, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=n)


@pytest.mark.parametrize("plan_flag", ["true", "false"])
def test_two_pass_student_matches_jax(plan_flag):
    """``model.crop_packing=false`` (with RoPE augmentation and drop path
    0.3): the loss terms and every student gradient against the JAX
    two-pass meta-arch, given JAX's plan ({"global", "local"}); under
    ``rng.plan`` true and false alike, since the plan decides the draws."""
    jmeta, tmeta, params, batch, jbatch = _meta_world(
        ROPE_AUG + ["model.crop_packing=false", f"rng.plan={plan_flag}"])
    assert not tmeta.packs(batch) and tmeta.rng_plan == (plan_flag == "true")
    plan = jax.tree.map(np.asarray, jmeta.build_rng_plan(
        jax.random.fold_in(jax.random.key(5), 0), jbatch))
    assert set(plan) == {"global", "local"}
    want, wg = _jax_losses_and_grads(jmeta, params, jbatch, plan)
    got, gg = _port_losses_and_grads(tmeta, batch, plan)
    _assert_close(got, want, gg, wg)


def test_packed_student_under_rng_plan_false_matches_jax():
    """``rng.plan=false`` with crop packing and RoPE augmentation: JAX's
    packed plan handed in gives JAX's losses and gradients."""
    jmeta, tmeta, params, batch, jbatch = _meta_world(ROPE_AUG + ["rng.plan=false"])
    assert tmeta.packs(batch) and not tmeta.rng_plan
    plan = jax.tree.map(np.asarray, jmeta.build_rng_plan(
        jax.random.fold_in(jax.random.key(6), 0), jbatch)["packed"])
    want, wg = _jax_losses_and_grads(jmeta, params, jbatch, {"packed": plan})
    got, gg = _port_losses_and_grads(tmeta, batch, plan)
    _assert_close(got, want, gg, wg)


def test_two_pass_student_equals_the_packed_student():
    """Without drop path, with the same RoPE factors per crop kind, the
    port's two-pass and packed students give the same losses and
    gradients (packing changes only which rows share an attention call)."""
    import copy

    _, tmeta, _, batch, _ = _meta_world(ROPE_AUG + ["student.drop_path_rate=0.0"], seed=3)
    fg, fl = _jax_factors(11), _jax_factors(12)
    packed, pg = _port_losses_and_grads(tmeta, batch, {"rope": {"global": fg, "local": fl}})
    two = copy.deepcopy(tmeta)
    two.crop_packing = False
    got, gg = _port_losses_and_grads(two, batch, {"global": {"rope": fg},
                                                  "local": {"rope": fl}})
    _assert_close(got, packed, gg, pg)


def test_steps_draw_their_own_plans_under_every_flag():
    """``build_train_setup`` + ``step_fn`` with the plan drawn by the step:
    every combination of packing and ``rng.plan`` with RoPE augmentation
    runs, its losses finite and a pure function of (seed, iteration), and
    the two derivations draw differently."""
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    seen = {}
    for packing in ("true", "false"):
        for plan_flag in ("true", "false"):
            _, tcfg = cfgs(ROPE_AUG + [f"model.crop_packing={packing}",
                                       f"rng.plan={plan_flag}"])
            batch = make_synthetic_batch(tcfg, B, seed=1)
            runs = []
            for _ in range(2):
                setup = build_train_setup(tcfg, batch, device="cpu", seed=3)
                _, m = setup.step_fn(setup.state, batch, setup.scalars(0))
                runs.append(m)
            assert runs[0] == runs[1] and all(np.isfinite(runs[0][k]) for k in LOSSES)
            seen[packing, plan_flag] = runs[0]["total_loss"]
    assert seen["true", "true"] != seen["true", "false"]
    assert seen["false", "true"] != seen["false", "false"]
