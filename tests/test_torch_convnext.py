"""The port's ConvNeXt family (``dinov3_tpu_torch/models/convnext.py``,
``ops/drop_path.py DropPath``, the ConvNeXt leaves of
``interop/from_jax.py``, the meta-arch, step, checkpoints and evals with a
ConvNeXt student) against the JAX package, on the CPU.

Inputs and perturbations are made with numpy from a seed; JAX's weights
are perturbed (so zero-initialised biases and the 1e-6 ``gamma`` count)
and bridged by ``interop/from_jax.py``. Both sides run in fp32; the JAX
LayerNorm takes its XLA path on the CPU, the port's its plain version
(kernels K4 / K5 on the card).

Tolerances:
- module forwards (``ConvNeXtBlock``, ``ConvNeXt``, the intermediate
  layers, the SAME-padded convs, the grid resize): 1e-5 of the output's
  largest magnitude (fp32 sums in other orders);
- ``DropPath`` on an injected mask, layouts, multipliers, refusals,
  checkpoints and loads: exact;
- the meta forward, both arms: loss terms 1e-5 relative, every student
  gradient within 1e-5 of its leaf's largest magnitude;
- one step: loss terms 1e-4 relative; the updated student and EMA teacher
  within Adam's sign-step bound (2 lr, times 1 - m for the teacher) plus
  1e-5 of each leaf's scale, 99 % of the entries within the 1e-5 alone
  (``tests/test_torch_train.py`` sets out why);
- the eval model on a JAX checkpoint: features 1e-5 of their largest
  magnitude.
"""

import copy
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_distill import distill, teacher_recipe, write_yaml

REPO = Path(__file__).resolve().parent.parent
B = 4
FWD = 1e-5
CNX = [
    "student.arch=convnext_test", "student.patch_size=4",
    "student.drop_path_rate=0.0", "student.layerscale=1.0e-5",
    "crops.global_crops_size=32", "crops.local_crops_size=16",
    "crops.local_crops_number=2",
    "dino.head_n_prototypes=64", "dino.head_hidden_dim=24",
    "dino.head_bottleneck_dim=8",
    "ibot.head_n_prototypes=64", "ibot.head_hidden_dim=24",
    "ibot.head_bottleneck_dim=8",
    "train.OFFICIAL_EPOCH_LENGTH=4", "optim.epochs=4",
    "optim.warmup_epochs=0", "optim.freeze_last_layer_epochs=0",
    "optim.layerwise_decay=0.8",
    "compute_precision.compute_dtype=fp32",
    "optim.scaling_rule=none",
    "loss.streaming_targets=false",
    "kernels.flash_attention=pallas",
]
LOSSES = ("dino_local_crops_loss", "dino_global_crops_loss", "koleo_loss",
          "ibot_loss", "total_loss")


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    """The JAX side reads the process's current mesh; these single-device
    comparisons run without one."""
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


def cfgs(extra=()):
    """(JAX cfg, port cfg) from the same overrides."""
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default

    jcfg, tcfg = get_default_config(), t_default()
    apply_dot_overrides(jcfg, CNX + list(extra))
    t_apply(tcfg, CNX + list(extra))
    return jcfg, tcfg


def _noisy(tree, seed, scale=0.05):
    import flax.linen as nn
    import jax

    leaves, treedef = jax.tree.flatten(nn.meta.unbox(tree))
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32)
        for a in leaves])


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, rel=FWD, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.size == 0:
        return
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max()
    assert err <= rel * scale, (what, err, scale)


def _noisy_shapes(shapes, seed):
    """numpy leaves for a tree of shapes: norm scales 1 + N(0, 0.05),
    every other leaf N(0, 0.05)."""
    import jax

    rng = np.random.default_rng(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree.unflatten(treedef, [
        (1.0 if getattr(path[-1], "key", "") == "scale" else 0.0)
        + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        for path, leaf in paths])


def _numpy_params(module, x, seed):
    """Parameters of the flax ``module`` for input ``x``, made with numpy
    from ``seed`` (``_noisy_shapes``; no JAX init pass)."""
    import flax.linen as nn
    import jax

    return _noisy_shapes(
        nn.meta.unbox(jax.eval_shape(module.init, jax.random.key(0), x))["params"], seed)


def _models(arch="convnext_test", seed=0, size=32, **kw):
    """A JAX ConvNeXt with numpy-seeded weights and the port's with the
    same weights, both fp32."""
    import jax.numpy as jnp

    from dinov3_tpu.models.convnext import get_convnext_arch as jarch

    from dinov3_tpu_torch.interop import state_dict_from_jax
    from dinov3_tpu_torch.models import get_convnext_arch

    jm = jarch(arch)(dtype=jnp.float32, **kw)
    params = _numpy_params(jm, jnp.zeros((1, size, size, 3), jnp.float32), seed + 1)
    with torch.device("meta"):
        tm = get_convnext_arch(arch)(dtype=torch.float32, **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True, assign=True)
    return jm, params, tm.eval()


def _images(n, size, seed=3):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


# ---------------- modules ----------------

def test_size_table_and_unknown_size():
    from dinov3_tpu.models.convnext import CONVNEXT_SIZES as JSIZES

    from dinov3_tpu_torch.models import CONVNEXT_SIZES, get_convnext_arch

    assert CONVNEXT_SIZES == JSIZES
    for size, table in CONVNEXT_SIZES.items():
        with torch.device("meta"):
            m = get_convnext_arch(f"convnext_{size}")()
        assert (m.depths, m.dims, m.embed_dim) == (table["depths"], table["dims"],
                                                   table["dims"][-1])
    with pytest.raises(ValueError, match="unknown convnext size"):
        get_convnext_arch("convnext_nope")


@pytest.mark.parametrize("dim,size", [(16, 7), (192, 7), (192, 8)])
def test_block_matches_jax_with_the_tanh_gelu(dim, size, monkeypatch):
    """``ConvNeXtBlock`` against JAX's at 7 and 8 wide (the 7 x 7 depthwise
    conv pads 3 a side); the exact GELU, which the ViT's FFN uses, misses
    the tolerance more than five times over."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.models.convnext import ConvNeXtBlock as JBlock

    import dinov3_tpu_torch.models.convnext as C
    from dinov3_tpu_torch.interop import convnext_state_dict_from_jax

    x = np.random.default_rng(3).standard_normal((2, size, size, dim)).astype(np.float32)
    jb = JBlock(dim, dtype=jnp.float32)
    params = _numpy_params(jb, jnp.asarray(x), 1)
    # GELU inputs of order 1 and a branch that weighs in the output
    params["pwconv1"]["kernel"] = params["pwconv1"]["kernel"] * (40.0 / np.sqrt(dim))
    params["gamma"] = params["gamma"] + 1.0
    want = np.asarray(jax.jit(jb.apply)({"params": params}, jnp.asarray(x)))
    tb = C.ConvNeXtBlock(dim, dtype=torch.float32)
    tb.load_state_dict(convnext_state_dict_from_jax(params), strict=True)
    got = _np(tb(torch.from_numpy(x)))
    _close(got, want, what="block")
    real = C.F.gelu
    monkeypatch.setattr(C.F, "gelu", lambda y, approximate="none": real(y))
    exact = _np(tb(torch.from_numpy(x)))
    assert np.abs(exact - want).max() > 5 * FWD * np.abs(want).max()


@pytest.mark.parametrize("arch,depths,size,patch", [
    ("convnext_test", None, 32, 4),
    ("convnext_test", None, 64, 16),
    ("convnext_test", None, 112, 16),   # stages 28, 14, 7, 4: 4 -> 7 grid
    ("convnext_test", None, 56, 4),     # stages 14, 7, 4, 2: 2 -> 14 grid
    ("convnext_large", (1, 1, 1, 1), 32, 4),
    ("convnext_large", (1, 1, 1, 1), 56, 16),
])
def test_convnext_forward_matches_jax(arch, depths, size, patch):
    """Every output key of the forward against JAX's, at the test widths
    and at ConvNeXt-L's (192 ... 1536) with its depths cut to one block a
    stage, at sizes whose stages run odd (the SAME-padded strided convs)
    and grids the pseudo patch grid upsamples."""
    import jax
    import jax.numpy as jnp

    kw = {"patch_size": patch, **({"depths": depths} if depths else {})}
    jm, params, tm = _models(arch, size=size, **kw)
    x = _images(2, size)
    masks = np.random.default_rng(4).random((2, (size // patch) ** 2)) < 0.3
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(masks))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(masks))
    assert set(got) == set(want)
    for k in ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens", "x_prenorm"):
        _close(_np(got[k]), np.asarray(want[k]), what=k)
    assert got["x_norm_patchtokens"].shape == (2, (size // patch) ** 2, tm.embed_dim)
    assert torch.equal(got["masks"], torch.from_numpy(masks))


@pytest.mark.parametrize("n,reshape,cls,norm", [
    (1, False, False, True), (2, True, True, True), ([0, 3], False, True, False),
    ([1, 3], True, False, True),
])
def test_intermediate_layers_match_jax(n, reshape, cls, norm):
    """``get_intermediate_layers``: the last n stages or a list, reshaped
    channels-last, with the pooled token, normed (stage 4 only)."""
    import functools

    import jax
    import jax.numpy as jnp

    jm, params, tm = _models(size=32, patch_size=4)
    x = _images(2, 32, seed=5)
    want = jax.jit(functools.partial(
        jm.apply, n=n, reshape=reshape, return_class_token=cls, norm=norm,
        method=jm.get_intermediate_layers))({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.get_intermediate_layers(torch.from_numpy(x), n, reshape=reshape,
                                         return_class_token=cls, norm=norm)
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g if cls else (g,), w if cls else (w,)):
            _close(_np(a), np.asarray(b), what=str(n))


@pytest.mark.parametrize("grid,out", [(8, 16), (4, 7), (16, 8), (7, 4)])
def test_pseudo_patch_grid_is_jax_image_resize_bilinear(grid, out):
    """The stage-4 map onto the patch grid: ``jax.image.resize(...,
    "bilinear")``, upsampling 8 -> 16 (256 px), 4 -> 7 (112 px), and
    downsampling, where JAX antialiases."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu_torch.models import get_convnext_arch

    feats = np.random.default_rng(6).standard_normal((2, grid, grid, 5)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(feats), (2, out, out, 5), "bilinear"))
    with torch.device("meta"):
        m = get_convnext_arch("convnext_test")(patch_size=4)
    got = m._pseudo_patch_grid(torch.from_numpy(feats), 4 * out, 4 * out)
    _close(_np(got), want, what=f"{grid}->{out}")


@pytest.mark.parametrize("n,kernel,stride", [(7, 2, 2), (30, 4, 4), (9, 4, 4), (7, 7, 1)])
def test_convs_pad_as_flax_same(n, kernel, stride):
    """``conv_nhwc`` against flax ``nn.Conv(padding="SAME")``: ceil(n /
    stride) outputs, the odd pad after (7 -> 4 at stride 2; 30 -> 8 at
    stride 4 pads one a side)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from dinov3_tpu_torch.models.convnext import conv_nhwc, same_pads

    groups = 6 if stride == 1 else 1
    conv = nn.Conv(6, (kernel, kernel), strides=(stride, stride), feature_group_count=groups,
                   dtype=jnp.float32)
    x = np.random.default_rng(7).standard_normal((2, n, n, 6)).astype(np.float32)
    p = _noisy(jax.tree.map(np.asarray, conv.init(jax.random.key(0), jnp.asarray(x))["params"]), 2)
    want = np.asarray(conv.apply({"params": p}, jnp.asarray(x)))
    tconv = torch.nn.Conv2d(6, 6, kernel, stride=stride, groups=groups)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1).copy()))
        tconv.bias.copy_(torch.from_numpy(p["bias"]))
        got = conv_nhwc(torch.from_numpy(x), tconv, torch.float32)
    assert got.shape[1] == -(-n // stride) and sum(same_pads(7, 2, 2)) == 1
    _close(_np(got), want, what="conv")


def test_drop_path_is_the_jax_mask_on_an_injected_mask(monkeypatch):
    """Rate 0 is the identity (with or without bits); at rate 0.3 the port
    gives JAX ``DropPath``'s where(mask, x / keep, 0) on the same mask
    (JAX's Bernoulli draw replaced by the injected bits); a training
    forward with drop path and no keep bits raises."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.ops.drop_path import DropPath as JDropPath

    from dinov3_tpu_torch.models import get_convnext_arch
    from dinov3_tpu_torch.ops.drop_path import DropPath, mask_keep_bits

    x = np.random.default_rng(8).standard_normal((6, 3, 3, 4)).astype(np.float32)
    bits = np.array([True, False, True, True, False, True])
    tx = torch.from_numpy(x)
    assert DropPath(0.0)(tx, torch.from_numpy(~bits)) is tx
    assert DropPath(0.3)(tx) is tx
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(bits).reshape(shape))
    want = np.asarray(JDropPath(0.3).apply({}, jnp.asarray(x), deterministic=False,
                                          rngs={"drop_path": jax.random.key(0)}))
    got = _np(DropPath(0.3)(tx, torch.from_numpy(bits)))
    assert np.array_equal(got, want)
    g = torch.Generator().manual_seed(0)
    drawn = torch.stack([mask_keep_bits(g, 4000, 0.3) for _ in range(3)])
    assert abs(drawn.float().mean().item() - 0.7) < 0.02
    m = get_convnext_arch("convnext_test")(dtype=torch.float32, drop_path_rate=0.2)
    with pytest.raises(ValueError, match="keep bits"):
        m(torch.zeros(1, 16, 16, 3), train=True)


def test_convnext_plan_draws_per_block_bits_by_key():
    """A pass's keep bits [n_blocks, rows], block i True with probability
    1 - rate_i (block 0's rate is 0), reproducible from the key and new for
    another iteration; no drop path, no bits."""
    from dinov3_tpu_torch.rng import convnext_plan

    rates = [0.0, 0.2, 0.4]
    plan = convnext_plan(1, 2, rates=rates, rows={"global": 4000, "local": 8000})
    keep = plan["local"]["drop_path"]["keep"]
    assert keep.shape == (3, 8000) and keep.dtype == torch.bool
    assert plan["global"]["drop_path"]["keep"].shape == (3, 4000)
    assert keep[0].all()
    for i in (1, 2):
        assert abs(keep[i].float().mean().item() - (1 - rates[i])) < 0.02
    again = convnext_plan(1, 2, rates=rates, rows={"global": 4000, "local": 8000})
    assert torch.equal(again["local"]["drop_path"]["keep"], keep)
    other = convnext_plan(1, 3, rates=rates, rows={"global": 4000, "local": 8000})
    assert not torch.equal(other["local"]["drop_path"]["keep"], keep)
    assert convnext_plan(1, 2, rates=[0.0] * 3, rows={"global": 4, "local": 8}) == {
        "global": {}, "local": {}}


# ---------------- the meta-arch ----------------

def _jax_world(extra=()):
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import SSLMetaArch

    prev = get_current_mesh()
    set_current_mesh(None)
    jcfg, tcfg = cfgs(extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    batch = make_synthetic_batch(jcfg, B, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(jmeta.init_params, jax.random.key(0), jbatch)
    params = {k: _noisy_shapes(shapes[k], seed) for k, seed in (("student", 1), ("teacher", 2))}
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # packing and the plan fall back silently
        tmeta = SSLMetaArch(tcfg)
    sds = meta_state_dicts_from_jax(params)
    tmeta.student.load_state_dict(sds["student"])
    tmeta.teacher.load_state_dict(sds["teacher"])
    set_current_mesh(prev)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmeta": jmeta, "tmeta": tmeta,
            "batch": batch, "jbatch": jbatch, "params": params}


@pytest.fixture(scope="module")
def teacher_yaml(tmp_path_factory):
    return write_yaml(tmp_path_factory.mktemp("teacher") / "teacher.yaml", teacher_recipe())


@pytest.fixture(scope="module")
def worlds(teacher_yaml):
    """The SSL arm (EMA ConvNeXt teacher) and the distillation arm (a
    ``vit_test_big`` teacher), JAX's and the port's on the same weights."""
    return {"ssl": _jax_world(), "distill": _jax_world(distill(teacher_yaml))}


def _jax_forward_grads(w, jbatch):
    import jax
    import jax.numpy as jnp

    jmeta, params = w["jmeta"], w["params"]
    teacher = jax.tree.map(jnp.asarray, params["teacher"])

    def loss(student):
        total, (d, _) = jmeta.forward(
            student, {"teacher": teacher}, jbatch, teacher_temp=0.07,
            state=jmeta.init_state(), iteration=jnp.asarray(0, jnp.int32),
            rngs={"drop_path": jax.random.key(0)})
        return total, d

    (_, jd), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params["student"])
    return jd, jgrads


@pytest.mark.parametrize("arm", ["ssl", "distill_in_step", "distill_serve"])
def test_meta_forward_and_every_student_grad_match_jax(worlds, arm):
    """Loss terms and every student gradient against JAX ``value_and_grad``
    with a ConvNeXt student: with its EMA ConvNeXt teacher (the iBOT masks
    reach the student, which sees the unmasked image), and distilled from a
    ViT teacher in the step or through the serve arm's planes."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import put_batch

    w = worlds["ssl" if arm == "ssl" else "distill"]
    jmeta, tmeta = w["jmeta"], w["tmeta"]
    assert not (tmeta.crop_packing or tmeta.rng_plan)
    assert not (jmeta.crop_packing or jmeta.rng_plan)
    jbatch, batch = dict(w["jbatch"]), dict(w["batch"])
    source = "serve" if arm == "distill_serve" else "in_step"
    if source == "serve":
        teacher = jax.tree.map(jnp.asarray, w["params"]["teacher"])
        cls, patches = jmeta.teacher_backbone_features(teacher, jbatch)
        planes = {"teacher_cls": np.asarray(cls, np.float32),
                  "teacher_patches": np.asarray(patches, np.float32)}
        # the teacher's patch grid is the ConvNeXt student's pseudo grid
        assert planes["teacher_patches"].shape[1] == (32 // 4) ** 2
        batch.update(planes)
        jbatch.update({k: jnp.asarray(v) for k, v in planes.items()})
    jmeta.teacher_source = tmeta.teacher_source = source
    try:
        jd, jgrads = _jax_forward_grads(w, jbatch)
        tmeta.student.zero_grad(set_to_none=True)
        total, d, _ = tmeta(put_batch(batch, "cpu"), teacher_temp=0.07)
        total.backward()
    finally:
        jmeta.teacher_source = tmeta.teacher_source = "in_step"
    assert list(d) == list(LOSSES) and set(d) == set(jd)
    for k in d:
        np.testing.assert_allclose(float(d[k].detach()), float(jd[k]), rtol=1e-5, err_msg=k)
    want = meta_state_dicts_from_jax({"g": jax.tree.map(np.asarray, jgrads)})["g"]
    names = [n for n, _ in tmeta.student.named_parameters()]
    assert set(names) == set(want)
    for n, p in tmeta.student.named_parameters():
        wg = want[n].numpy()
        g = np.zeros_like(wg) if p.grad is None else _np(p.grad)
        np.testing.assert_allclose(g, wg, atol=1e-5 * max(np.abs(wg).max(), 1e-6), err_msg=n)
    assert not any(p.grad is not None for p in tmeta.teacher.parameters())
    tmeta.student.zero_grad(set_to_none=True)


def test_multipliers_match_jax_and_take_no_layerwise_decay(worlds):
    """Every ConvNeXt leaf's lr / wd multipliers and last-layer flag against
    JAX ``build_multiplier_trees`` at layerwise_decay 0.8: no stage block is
    a ``blocks`` layer, so every backbone lr multiplier is 1; wd is 0 for
    biases, norms and ``gamma``."""
    import jax

    from dinov3_tpu.train.param_groups import build_multiplier_trees

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train.param_groups import build_multipliers

    w = worlds["ssl"]
    student = w["params"]["student"]
    kw = dict(layerwise_decay=0.8, patch_embed_lr_mult=0.2, dino_head_wd_multiplier=0.5)
    trees = build_multiplier_trees(student, **kw)
    bridged = [meta_state_dicts_from_jax({"s": jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), tree, student)})["s"]
        for tree in trees]
    ours = build_multipliers(bridged[0].keys(), **kw)
    assert ours.keys() == set(w["tmeta"].student.state_dict())
    for name, m in ours.items():
        assert np.allclose(bridged[0][name].numpy(), m.lr, rtol=1e-6), name
        assert np.allclose(bridged[1][name].numpy(), m.wd), name
        assert bool(bridged[2][name].numpy().all()) == m.is_last_layer, name
        if name.startswith("backbone."):
            assert m.lr == 1.0, name
            zero_wd = name.endswith(("bias", "gamma")) or "norm" in name
            assert m.wd == (0.0 if zero_wd else 1.0), name


@pytest.mark.parametrize("arm", ["ssl", "distill"])
def test_one_step_matches_jax_step(worlds, arm):
    """One step of the port's step against JAX ``make_train_step`` (its
    fused update) from the same state and batch, with layerwise_decay 0.8:
    the updated student and the EMA teacher (SSL) or the frozen teacher,
    unchanged on both sides (distillation)."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.train.fused_update import build_fused_update
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState, make_train_step

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
    from dinov3_tpu_torch.train.schedules import build_schedules
    from dinov3_tpu_torch.train.train_step import TrainState as TState
    from dinov3_tpu_torch.train.train_step import make_train_step as t_make

    w = worlds[arm]
    jcfg, tcfg, jmeta, params = w["jcfg"], w["tcfg"], w["jmeta"], w["params"]
    ema = arm == "ssl"
    sched = jsched(jcfg)
    opt = build_optimizer(jcfg, params["student"], sched)
    fused = build_fused_update(jcfg, params["student"], sched, ema=ema)
    jstep = jax.jit(make_train_step(jmeta, opt, clip_grad=jcfg.optim.clip_grad,
                                    fused_update=fused))
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        jmeta.init_state(), jnp.zeros((), jnp.int32))
    tmeta = copy.deepcopy(w["tmeta"])
    o = tcfg.optim
    assert o.layerwise_decay < 1
    topt = ScheduledAdamW(tmeta.student, build_schedules(tcfg),
                          layerwise_decay=o.layerwise_decay,
                          patch_embed_lr_mult=o.patch_embed_lr_mult,
                          dino_head_wd_multiplier=o.dino_head_wd_multiplier,
                          clip_grad=o.clip_grad, ema=ema)
    tstate = TState(meta=tmeta, opt_state=topt.init_state(tmeta.student))
    s = sched.at(0)
    jstate, jm = jstep(jstate, w["jbatch"], {"teacher_temp": jnp.float32(s["teacher_temp"]),
                                             "momentum": jnp.float32(s["momentum"])},
                       jax.random.key(5))
    tstate, tm = t_make(topt)(tstate, w["batch"], {"teacher_temp": s["teacher_temp"],
                                                   "momentum": s["momentum"]})
    for k in LOSSES:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    lr = float(s["lr"])
    assert lr > 0
    bounds = {"student": 2 * lr, "teacher": (1 - float(s["momentum"])) * 2 * lr}
    for role in ("student", "teacher"):
        want = meta_state_dicts_from_jax(
            {"x": jax.tree.map(np.asarray, jstate.params[role])})["x"]
        got = getattr(tmeta, role).state_dict()
        assert got.keys() == want.keys()
        close = total = 0
        for n, wv in want.items():
            wv = wv.numpy()
            err = np.abs(_np(got[n]) - wv)
            tol = 1e-5 * max(np.abs(wv).max(), 1e-3)
            if role == "teacher" and not ema:
                assert np.array_equal(_np(got[n]), wv), n
            assert (err <= tol + bounds[role]).all(), (role, n, err.max())
            close += int((err <= tol).sum())
            total += err.size
        assert close >= 0.99 * total, (role, close, total)
    assert tstate.step == 1


# ---------------- refusals and fallbacks ----------------

@pytest.mark.parametrize("arm", ["fp8", "int8"])
def test_lowp_arm_with_a_convnext_raises_in_jax_words(arm):
    """An fp8 / int8 ``train.low_precision.arm`` with a ConvNeXt arch:
    ``ValueError`` with the JAX package's message, from the meta-arch and
    the model factories; the bf16 arm builds."""
    from dinov3_tpu.models import build_backbone as jbuild

    from dinov3_tpu_torch.models import build_backbone, build_model_for_eval
    from dinov3_tpu_torch.train import SSLMetaArch

    jcfg, tcfg = cfgs([f"train.low_precision.arm={arm}"])
    with pytest.raises(ValueError) as want:
        jbuild(jcfg)
    for call in (lambda: SSLMetaArch(tcfg), lambda: build_backbone(tcfg, device="cpu"),
                 lambda: build_model_for_eval(tcfg, device="cpu")):
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)
    assert build_backbone(cfgs()[1], device="cpu").embed_dim == 64


def test_packing_and_the_plan_fall_back_silently():
    """Crop packing and the step plan asked for explicitly turn off for a
    ConvNeXt without a warning, as in JAX, so no batch runs packed; a
    ViT's ``n_blocks`` cut is refused by name."""
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import SSLMetaArch

    extra = ["model.crop_packing=true", "rng.plan=true"]
    jcfg, tcfg = cfgs(extra)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        jmeta = JMeta(jcfg)
    assert not [w for w in seen if "packing" in str(w.message) or "rng" in str(w.message)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        meta = SSLMetaArch(tcfg)
    assert (meta.crop_packing, meta.rng_plan) == (jmeta.crop_packing, jmeta.rng_plan) == (
        False, False)
    batch = make_synthetic_batch(tcfg, B, seed=0)
    assert not meta.packs(batch)
    assert meta.plan_rows(batch) == {"global": 2 * B, "local": 2 * B}
    with pytest.raises(ValueError, match="student.depths"):
        SSLMetaArch(tcfg, n_blocks=2)


def test_depths_override_cuts_the_stages():
    """``+student.depths=[...]`` cuts the stage depths at full width, for
    the card's runs at ConvNeXt-L widths."""
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.models import build_model_for_eval

    cfg = load_config(None, ["student.arch=convnext_large", "+student.depths=[1,1,2,1]",
                             "compute_precision.compute_dtype=fp32"], n_devices=1)
    m = build_model_for_eval(cfg, device="cpu")
    assert (m.depths, m.dims) == ((1, 1, 2, 1), (192, 384, 768, 1536))
    assert hasattr(m, "stage2_block1") and not hasattr(m, "stage2_block2")


# ---------------- the serve arm, checkpoints and evals ----------------

def test_teacher_server_planes_fit_the_convnext_students_tokens(teacher_yaml):
    """The serve arm's planes (``teacher_feature_example`` and
    ``TeacherServer.annotate``) against JAX's, and their token count is
    the ConvNeXt student's pseudo patch grid."""
    from dinov3_tpu.train.distillation import teacher_feature_example as jexample

    from dinov3_tpu_torch.models import build_backbone
    from dinov3_tpu_torch.train.distillation import TeacherServer, teacher_feature_example

    jcfg, tcfg = cfgs(distill(teacher_yaml, "serve"))
    ex, want = teacher_feature_example(tcfg, 6), jexample(jcfg, 6)
    assert {k: (v.shape, v.dtype) for k, v in ex.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    g = np.random.default_rng(9).standard_normal((3, 32, 32, 3)).astype(np.float32)
    srv = TeacherServer(tcfg, warn=False, device="cpu")
    planes = srv.annotate({"global_crops": g})
    tokens = build_backbone(tcfg, device="cpu")(torch.from_numpy(g))["x_norm_patchtokens"]
    assert planes["teacher_patches"].shape[:2] == tuple(tokens.shape[:2]) == (3, 64)
    assert planes["teacher_cls"].shape == (3, 96)


def test_checkpoint_round_trip_and_exact_resume(tmp_path):
    """A ConvNeXt run's state (student, EMA teacher, moments, centers) saved
    and restored bitwise into a fresh set-up; both then take the same step
    bitwise; ``teacher_backbone_state_dict`` reads the EMA teacher's
    ConvNeXt backbone."""
    from dinov3_tpu_torch.checkpoint import (
        Checkpointer,
        state_payload,
        teacher_backbone_state_dict,
    )
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    _, cfg = cfgs(["student.drop_path_rate=0.2"])
    batch = make_synthetic_batch(cfg, B, seed=0)
    a = build_train_setup(cfg, batch, device="cpu", seed=1)
    a.state, _ = a.step_fn(a.state, batch, a.scalars(0))
    Checkpointer(str(tmp_path / "ckpt")).save(1, a.state)
    b = build_train_setup(cfg, batch, device="cpu", seed=1)  # the run's seed keys its plans
    Checkpointer(str(tmp_path / "ckpt")).restore(b.state)

    def same(x, y):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            return all(same(x[k], y[k]) for k in x)
        return torch.equal(x, y) if torch.is_tensor(x) else x == y

    assert same(state_payload(a.state), state_payload(b.state))
    step, sd = teacher_backbone_state_dict(str(tmp_path / "ckpt"))
    assert step == 1 and same(sd, a.meta.teacher["backbone"].state_dict())
    batch2 = make_synthetic_batch(cfg, B, seed=1)
    a.state, ma = a.step_fn(a.state, batch2, a.scalars(1))
    b.state, mb = b.step_fn(b.state, batch2, b.scalars(1))
    assert ma == mb
    assert same(state_payload(a.state), state_payload(b.state))


def test_weight_bridge_and_eval_model_on_a_jax_local_checkpoint(worlds, tmp_path):
    """A JAX ConvNeXt ``TrainState`` in the JAX package's local-npz layout:
    ``train_state_from_jax`` gives the port's student, teacher and moments
    (keyed by the student's names), and ``build_model_for_eval(ckpt_dir=)``
    reads its EMA teacher backbone, whose features are JAX's."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from dinov3_tpu.models import build_backbone as jbuild
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState

    from dinov3_tpu_torch.interop import train_state_from_jax
    from dinov3_tpu_torch.models import build_model_for_eval

    w = worlds["ssl"]
    jcfg, tcfg, params = w["jcfg"], w["tcfg"], w["params"]
    opt = build_optimizer(jcfg, params["student"], jsched(jcfg))
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        w["jmeta"].init_state(), jnp.asarray(3, jnp.int32))
    ckpt = JaxCheckpointer(str(tmp_path / "jax"), async_save=False)
    try:
        ckpt._local_save(3, jstate)
    finally:
        ckpt.close()
    with np.load(tmp_path / "jax" / "3" / "state.npz") as f:
        bridged = train_state_from_jax(dict(f))
    names = set(w["tmeta"].student.state_dict())
    assert set(bridged["student"]) == set(bridged["mu"]) == set(bridged["nu"]) == names
    assert bridged["step"] == 3
    model = build_model_for_eval(tcfg, str(tmp_path / "jax"), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, bridged["teacher"][f"backbone.{k}"]), k
    x = _images(3, 32, seed=10)
    jm = jbuild(jcfg, teacher=True)
    want = jax.jit(jm.apply)({"params": params["teacher"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("x_norm_clstoken", "x_norm_patchtokens"):
        _close(_np(got[k]), np.asarray(want[k]), what=k)


def test_eval_model_is_built_on_meta_and_drawn_on_the_device():
    """``build_model_for_eval`` without a checkpoint builds on ``meta`` and
    draws on the requested device: on the CPU the weights are
    ``build_backbone``'s, for a ViT and a ConvNeXt."""
    import dinov3_tpu_torch.models as M
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config

    for arch in ("vit_test", "convnext_test"):
        cfg = get_default_config()
        apply_dot_overrides(cfg, [f"student.arch={arch}", "student.patch_size=4"])
        want = M.build_backbone(cfg, device="cpu", seed=3).state_dict()
        built = []
        real = M.vit_ctor

        def spy(c):
            ctor = real(c)

            def build(**kw):
                built.append(torch.empty(0).device.type)
                return ctor(**kw)

            return build

        M.vit_ctor = spy
        try:
            got = M.build_model_for_eval(cfg, device="cpu", seed=3)
        finally:
            M.vit_ctor = real
        assert built == ["meta"]
        assert got.state_dict().keys() == want.keys()
        for k, v in want.items():
            assert v.dtype == got.state_dict()[k].dtype and torch.equal(got.state_dict()[k], v), k
        assert not any(p.requires_grad for p in got.parameters()) and not got.training


def test_trainer_and_eval_clis_run_a_convnext_on_the_cpu(tmp_path):
    """The trainer CLI with ``student.arch=convnext_test`` (drop path on,
    two iterations, a save at 2) and the eval CLI on its checkpoint, in
    child processes on the CPU."""
    from test_torch_evals import SYN_TRAIN, SYN_VAL

    cli = ["MODEL.DEVICE=cpu", *CNX, "student.drop_path_rate=0.2",
           f"train.batch_size_per_device={B}", "checkpointing.period=2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "dinov3_tpu_torch.train.train", "--output-dir",
         str(tmp_path / "run"), "--max-iterations", "2", *cli],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["iterations"] == 2 and np.isfinite(result["final_loss"])
    assert (result["crop_packing"], result["rng_plan"], result["remat"]) == (False, False, "none")
    assert (tmp_path / "run" / "ckpt" / "2" / "FINALIZED").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "dinov3_tpu_torch.evals", "--ckpt", str(tmp_path / "run" / "ckpt"),
         "--batch-size", "8", "--probe-epochs", "1", "--max-train-samples", "16",
         "--max-val-samples", "8", *cli, "train.num_workers=2",
         f"evaluation.train_dataset_path={SYN_TRAIN}",
         f"evaluation.val_dataset_path={SYN_VAL}"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    evals = json.loads(proc.stdout.strip().splitlines()[-1])
    assert 0.0 <= evals["knn10_top1"] <= 100.0
