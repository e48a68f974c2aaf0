"""The port's distillation (``dinov3_tpu_torch/train/distillation.py``,
``multidistillation.py``, ``pretrained.py``, the meta-arch's frozen
teacher, ``Checkpointer.restore_params_only`` and the trainer's wiring)
against the JAX package, on the CPU at test widths: a ``vit_test`` student
(the ``SMOL`` overrides of ``tests/test_torch_train.py``, fp32, drop path
0.3) distilling from a ``vit_test_big`` teacher (96 wide, heads of hidden
width 48 and bottleneck 16, separate iBOT head), 16 px global crops, 64
prototypes: the configs of ``tests/test_distillation.py`` and
``tests/test_distill_serve.py``. Inputs are made with numpy from a seed;
weights are JAX's, perturbed, bridged by ``interop/from_jax.py``.

JAX is imported inside the tests that use it, so the ``cuda`` case runs
on the card without it (``--noconftest``).

Tolerances:
- the config refusals, the routing, checkpoints, loads and warm starts:
  exact (the same messages, assignments and bits);
- the meta forward under distillation, both teacher sources: loss terms
  1e-5 relative in fp32, every student gradient within 1e-5 of its leaf's
  largest magnitude;
- the serve arm fed the in-step teacher's own features: its targets and
  centers bitwise the in-step arm's (fp32 planes hold bf16 exactly);
- one step against JAX's step: loss terms 1e-4 relative; the student
  within Adam's sign-step bound (2 lr) plus 1e-5 of each leaf's scale,
  99 % of it within the 1e-5 alone; the teacher bitwise unchanged on both
  sides;
- ``TeacherServer`` against JAX's on the same weights, bf16 serving
  weights: 2^-5 of the largest feature magnitude (``tests/test_torch_serve.py``);
  hits bitwise their misses;
- on the card: the served teacher (K1 with segment ids, bf16) against the
  in-step teacher (K1 without): 2^-5 of the largest feature magnitude.
"""

import copy
import json
import os
import shutil
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
B = 4
# tests/test_torch_train.py's SMOL with lr > 0 at iteration 0, so a step
# moves the student
SMOL = [
    "student.arch=vit_test", "student.patch_size=4",
    "student.drop_path_rate=0.3", "student.layerscale=1.0e-5",
    "crops.global_crops_size=16", "crops.local_crops_size=8",
    "crops.local_crops_number=2",
    "dino.head_n_prototypes=64", "dino.head_hidden_dim=24",
    "dino.head_bottleneck_dim=8",
    "ibot.head_n_prototypes=64", "ibot.head_hidden_dim=24",
    "ibot.head_bottleneck_dim=8",
    "train.OFFICIAL_EPOCH_LENGTH=4", "optim.epochs=4",
    "optim.warmup_epochs=0", "optim.freeze_last_layer_epochs=0",
    "compute_precision.compute_dtype=fp32",
    "optim.scaling_rule=none",
    "loss.streaming_targets=false",
    "kernels.flash_attention=pallas",
]
LOSSES = ("dino_local_crops_loss", "dino_global_crops_loss", "koleo_loss",
          "ibot_loss", "total_loss")
BF16_FEATURES = 2.0 ** -5


def teacher_recipe(arch="vit_test_big", hidden=48, dtype="fp32", **extra) -> dict:
    """The teacher's own recipe (``tests/test_distill_serve.py``'s, fp32
    unless ``dtype``): 64 prototypes, heads of hidden width ``hidden``."""
    return {
        "student": {"arch": arch, "patch_size": 4, "drop_path_rate": 0.0, **extra},
        "dino": {"head_n_prototypes": 64, "head_hidden_dim": hidden,
                 "head_bottleneck_dim": 16},
        "ibot": {"head_n_prototypes": 64, "head_hidden_dim": hidden,
                 "head_bottleneck_dim": 16},
        "crops": {"global_crops_size": 16, "local_crops_size": 8, "local_crops_number": 2},
        "optim": {"scaling_rule": "none"},
        "compute_precision": {"compute_dtype": dtype},
        "kernels": {"flash_attention": "pallas"},
    }


def write_yaml(path, recipe: dict) -> str:
    Path(path).write_text(yaml.safe_dump(recipe))
    return str(path)


def distill(teacher_yaml, source="in_step") -> list:
    return ["distillation.enabled=true", f"distillation.full_cfg_path={teacher_yaml}",
            f"distillation.teacher_source={source}"]


def cfgs(extra=()):
    """(JAX cfg, port cfg) from the same overrides."""
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default

    jcfg, tcfg = get_default_config(), t_default()
    apply_dot_overrides(jcfg, SMOL + list(extra))
    t_apply(tcfg, SMOL + list(extra))
    return jcfg, tcfg


def port_cfg(extra=()):
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config

    cfg = get_default_config()
    apply_dot_overrides(cfg, SMOL + list(extra))
    return cfg


def _noisy(tree, seed, scale=0.05):
    import jax

    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])


def _np(t):
    return t.detach().float().numpy()


def _jax_plan(jmeta, jbatch, it, seed=5):
    import jax

    plan = jmeta.build_rng_plan(jax.random.fold_in(jax.random.key(seed), it), jbatch)
    return jax.tree.map(np.asarray, plan["packed"])


def _load(meta, params) -> None:
    """The JAX params {"student", "teacher"} into the port's meta-arch."""
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax

    sds = meta_state_dicts_from_jax(params)
    meta.student.load_state_dict(sds["student"])
    meta.teacher.load_state_dict(sds["teacher"])


def _equal_sd(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.fixture
def _no_ambient_mesh():
    """The JAX side reads the process's current mesh; these single-device
    comparisons run without one (as in ``tests/test_torch_train.py``)."""
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


@pytest.fixture(scope="module")
def teacher_yaml(tmp_path_factory):
    return write_yaml(tmp_path_factory.mktemp("teacher") / "teacher.yaml", teacher_recipe())


@pytest.fixture(scope="module")
def dworld(teacher_yaml):
    """The JAX meta-arch under distillation with a perturbed student and
    teacher, one batch, and the port's meta-arch holding the same
    weights."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.train import SSLMetaArch

    prev = get_current_mesh()
    set_current_mesh(None)
    jcfg, tcfg = cfgs(distill(teacher_yaml))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    batch = make_synthetic_batch(jcfg, B, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jmeta.init_params(jax.random.key(0), jbatch))
    params = {"student": _noisy(params["student"], 1), "teacher": _noisy(params["teacher"], 2)}
    tmeta = SSLMetaArch(tcfg)
    _load(tmeta, params)
    set_current_mesh(prev)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmeta": jmeta, "tmeta": tmeta,
            "batch": batch, "jbatch": jbatch, "params": params}


# ---------------- the teacher's config ----------------

@pytest.mark.parametrize("bad", ["no_path", "separate_head", "prototypes", "patch_size"])
def test_resolve_distillation_cfg_refuses_with_jax_words(tmp_path, bad):
    """A missing path, a teacher without a separate iBOT head, other
    prototype counts or another patch size: ``ValueError`` with the JAX
    package's message; a good teacher resolves to its own recipe."""
    from dinov3_tpu.train.distillation import resolve_distillation_cfg as jresolve

    from dinov3_tpu_torch.train.distillation import resolve_distillation_cfg

    recipe = teacher_recipe()
    extra = []
    if bad == "separate_head":
        recipe["ibot"]["separate_head"] = False
    elif bad == "prototypes":
        extra = ["dino.head_n_prototypes=128"]
    elif bad == "patch_size":
        recipe["student"]["patch_size"] = 8
    path = write_yaml(tmp_path / "t.yaml", recipe)
    good = cfgs(distill(write_yaml(tmp_path / "good.yaml", teacher_recipe())))[1]
    assert resolve_distillation_cfg(good).student.arch == "vit_test_big"
    jcfg, tcfg = cfgs(distill("" if bad == "no_path" else path) + extra)
    with pytest.raises(ValueError) as want:
        jresolve(jcfg)
    with pytest.raises(ValueError) as got:
        resolve_distillation_cfg(tcfg)
    assert str(got.value) == str(want.value)


def test_the_teacher_is_its_own_recipe_drawn_apart_and_frozen(teacher_yaml, monkeypatch):
    """The teacher backbone and heads take the teacher recipe's widths with
    the student's prototype counts, its parameters carry no gradient and
    their draws are not the student's; every parameter is drawn (modules
    filled with NaN before the draws keep none); ``distillation.teacher_source``
    resolves, and a bad value raises."""
    import dinov3_tpu_torch.train.ssl_meta_arch as M
    from dinov3_tpu_torch.train import SSLMetaArch

    real = M._uninitialized

    def nan_filled(build, *args, **kwargs):
        module = real(build, *args, **kwargs)
        with torch.no_grad():
            for p in module.parameters():
                p.fill_(float("nan"))
        return module

    monkeypatch.setattr(M, "_uninitialized", nan_filled)
    meta = SSLMetaArch(port_cfg(distill(teacher_yaml)), seed=3)
    assert [n for n, p in meta.named_parameters() if torch.isnan(p).any()] == []
    t = meta.teacher
    assert meta.distillation and meta.teacher_source == "in_step"
    assert (t["backbone"].embed_dim, t["backbone"].n_blocks, meta.embed_dim) == (96, 3, 64)
    assert t["dino_head"].mlp[0].weight.shape == (48, 96)
    assert t["dino_head"].last_layer.weight.shape == (64, 16)
    assert t["ibot_head"].last_layer.weight.shape == (64, 16)
    assert not any(p.requires_grad for p in t.parameters())
    a = meta.student["backbone"].cls_token.flatten()[:8]
    b = t["backbone"].cls_token.flatten()[:8]
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="in_step"):
        SSLMetaArch(port_cfg(distill(teacher_yaml, "sometimes")))


# ---------------- the meta-arch ----------------

@pytest.mark.parametrize("source", ["in_step", "serve"])
def test_distill_meta_forward_and_every_student_grad_match_jax(dworld, source,
                                                               _no_ambient_mesh):
    """Loss terms and every student gradient against JAX ``value_and_grad``
    under distillation. The serve arm takes the in-step teacher's features
    as the batch planes, on both sides."""
    import jax
    import jax.numpy as jnp

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.rng import plan_to_device
    from dinov3_tpu_torch.train import put_batch

    w = dworld
    jmeta, tmeta, params = w["jmeta"], w["tmeta"], w["params"]
    jbatch, batch = dict(w["jbatch"]), dict(w["batch"])
    jteacher = jax.tree.map(jnp.asarray, params["teacher"])
    if source == "serve":
        cls, patches = jmeta.teacher_backbone_features(jteacher, jbatch)
        planes = {"teacher_cls": np.asarray(cls, np.float32),
                  "teacher_patches": np.asarray(patches, np.float32)}
        batch.update(planes)
        jbatch.update({k: jnp.asarray(v) for k, v in planes.items()})
    plan = _jax_plan(jmeta, w["jbatch"], 0)
    jmeta.teacher_source = tmeta.teacher_source = source
    try:
        def loss(student):
            total, (d, _) = jmeta.forward(
                student, {"teacher": jteacher}, jbatch, teacher_temp=0.07,
                state=jmeta.init_state(), iteration=jnp.asarray(0, jnp.int32),
                rng_plan={"packed": plan})
            return total, d

        (_, jd), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params["student"])
        tmeta.student.zero_grad(set_to_none=True)
        total, d, _ = tmeta(put_batch(batch, "cpu"), teacher_temp=0.07,
                            plan=plan_to_device(plan, "cpu"))
        total.backward()
    finally:
        jmeta.teacher_source = tmeta.teacher_source = "in_step"
    assert list(d) == list(LOSSES) and set(d) == set(jd)
    for k in d:
        np.testing.assert_allclose(float(d[k].detach()), float(jd[k]), rtol=1e-5, err_msg=k)
    want = meta_state_dicts_from_jax({"g": jax.tree.map(np.asarray, jgrads)})["g"]
    for n, p in tmeta.student.named_parameters():
        wg = want[n].numpy()
        g = np.zeros_like(wg) if p.grad is None else _np(p.grad)
        np.testing.assert_allclose(g, wg, atol=1e-5 * max(np.abs(wg).max(), 1e-6), err_msg=n)
    assert not any(p.grad is not None for p in tmeta.teacher.parameters())
    tmeta.student.zero_grad(set_to_none=True)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


@pytest.mark.parametrize("centering", ["sinkhorn_knopp", "softmax_center"])
def test_serve_arm_targets_are_the_in_step_targets_bitwise(tmp_path, centering):
    """A bf16 teacher's own features fed through the serve arm's fp32
    planes give the in-step arm's targets and centers bit for bit; a
    batch without the planes raises."""
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import SSLMetaArch, put_batch

    path = write_yaml(tmp_path / "t.yaml", teacher_recipe(dtype="bf16"))
    cfg = port_cfg(distill(path) + [f"train.centering={centering}"])
    meta = SSLMetaArch(cfg, seed=1)
    batch = put_batch(make_synthetic_batch(cfg, B, seed=2), "cpu")
    state = {k: v + 0.01 for k, v in meta.init_state().items()}
    want, want_state = meta.get_teacher_output(batch, 0.05, state)
    cls, patches = meta.teacher_backbone_features(batch)
    assert cls.dtype == torch.bfloat16
    served = {**batch, "teacher_cls": cls.float(), "teacher_patches": patches.float()}
    meta.teacher_source = "serve"
    got, got_state = meta.get_teacher_output(served, 0.05, state)
    with pytest.raises(ValueError, match="teacher_cls"):
        meta.get_teacher_output(batch, 0.05, state)
    a, b = _leaves((want, want_state)), _leaves((got, got_state))
    assert len(a) == len(b) > 4
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_distill_step_matches_jax_step_and_the_teacher_stays_frozen(dworld, _no_ambient_mesh):
    """One step of the port's step against JAX ``make_train_step`` with its
    fused update under distillation (no EMA), same state, batch and plan."""
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

    w = dworld
    jcfg, tcfg, jmeta, params = w["jcfg"], w["tcfg"], w["jmeta"], w["params"]
    sched = jsched(jcfg)
    opt = build_optimizer(jcfg, params["student"], sched)
    fused = build_fused_update(jcfg, params["student"], sched, ema=False)
    jstep = jax.jit(make_train_step(jmeta, opt, clip_grad=jcfg.optim.clip_grad,
                                    fused_update=fused))
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        jmeta.init_state(), jnp.zeros((), jnp.int32))
    tmeta = copy.deepcopy(w["tmeta"])
    teacher0 = {k: v.clone() for k, v in tmeta.teacher.state_dict().items()}
    o = tcfg.optim
    topt = ScheduledAdamW(tmeta.student, build_schedules(tcfg),
                          layerwise_decay=o.layerwise_decay,
                          patch_embed_lr_mult=o.patch_embed_lr_mult,
                          dino_head_wd_multiplier=o.dino_head_wd_multiplier,
                          clip_grad=o.clip_grad, ema=not tmeta.distillation)
    tstate = TState(meta=tmeta, opt_state=topt.init_state(tmeta.student))
    s = sched.at(0)
    jstate, jm = jstep(jstate, w["jbatch"], {"teacher_temp": jnp.float32(s["teacher_temp"]),
                                             "momentum": jnp.float32(s["momentum"])},
                       jax.random.key(5))
    tstate, tm = t_make(topt)(tstate, w["batch"], {"teacher_temp": s["teacher_temp"],
                                                   "momentum": s["momentum"]},
                              plan=_jax_plan(jmeta, w["jbatch"], 0))
    for k in LOSSES:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4, err_msg=k)
    for a, b in zip(jax.tree.leaves(params["teacher"]),
                    jax.tree.leaves(jax.tree.map(np.asarray, jstate.params["teacher"]))):
        assert np.array_equal(a, b)
    _equal_sd(tmeta.teacher.state_dict(), teacher0)
    lr = float(s["lr"])
    assert lr > 0
    want = meta_state_dicts_from_jax(
        {"s": jax.tree.map(np.asarray, jstate.params["student"])})["s"]
    got = tmeta.student.state_dict()
    close = total = 0
    for n, wv in want.items():
        wv = wv.numpy()
        err = np.abs(_np(got[n]) - wv)
        tol = 1e-5 * max(np.abs(wv).max(), 1e-3)
        assert (err <= tol + 2 * lr).all(), (n, err.max(), tol + 2 * lr)
        close += int((err <= tol).sum())
        total += err.size
    assert close >= 0.99 * total, (close, total)
    assert tstate.step == 1 and len(tstate.opt_state.mu) == len(list(tmeta.student.parameters()))


# ---------------- the serve-backed teacher ----------------

def test_teacher_feature_example_and_the_setup_refuses_planeless_serve_batches(
        teacher_yaml):
    """The zero planes have the shapes ``annotate`` gives (the teacher's
    width by the student run's patch grid), as JAX's do; a serve-arm
    set-up whose example batch lacks them raises."""
    from dinov3_tpu.train.distillation import teacher_feature_example as jexample

    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup
    from dinov3_tpu_torch.train.distillation import teacher_feature_example

    jcfg, tcfg = cfgs(distill(teacher_yaml, "serve"))
    ex, want = teacher_feature_example(tcfg, 6), jexample(jcfg, 6)
    assert ex["teacher_cls"].shape == (6, 96) and ex["teacher_patches"].shape == (6, 16, 96)
    assert {k: (v.shape, v.dtype) for k, v in ex.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}
    assert not any(v.any() for v in ex.values())
    batch = make_synthetic_batch(tcfg, B, seed=0)
    with pytest.raises(ValueError, match="teacher_cls"):
        build_train_setup(tcfg, batch, device="cpu")
    setup = build_train_setup(tcfg, {**batch, **teacher_feature_example(tcfg, 2 * B)},
                              device="cpu")
    assert setup.meta.teacher_source == "serve"


@pytest.fixture(scope="module")
def servers(dworld):
    """JAX's ``TeacherServer`` and the port's on the same teacher weights."""
    from dinov3_tpu.train.distillation import TeacherServer as JServer

    from dinov3_tpu_torch.train.distillation import TeacherServer

    w = dworld
    jsrv = JServer(w["jcfg"], teacher_params=w["params"]["teacher"]["backbone"], warn=False)
    tsrv = TeacherServer(w["tcfg"], teacher_params=w["tmeta"].teacher["backbone"].state_dict(),
                         warn=False, device="cpu")
    return jsrv, tsrv


def test_teacher_server_features_match_jax(servers):
    """The same crops through JAX's server and the port's: the planes agree
    at bf16 serving precision; the layout serves exactly the crop size."""
    jsrv, tsrv = servers
    g = np.random.default_rng(3).standard_normal((5, 16, 16, 3)).astype(np.float32)
    want, got = jsrv.annotate({"global_crops": g}), tsrv.annotate({"global_crops": g})
    layout = tsrv.engine.layout
    assert (layout.min_px, layout.max_px) == (16, 16) == (jsrv.engine.layout.min_px,
                                                         jsrv.engine.layout.max_px)
    for k in ("teacher_cls", "teacher_patches"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], atol=BF16_FEATURES * scale, err_msg=k)
    assert set(tsrv.stats()) == set(jsrv.stats())


def test_teacher_server_dedups_replays_bitwise_and_builds_once(servers):
    """Misses forward once per distinct crop (duplicates within a batch
    too), a replay is all hits with bitwise-equal planes, and the engine
    builds its step once (``compile_count``)."""
    _, srv = servers
    rng = np.random.default_rng(7)
    g = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    base = srv.teacher_forwards
    ann = srv.annotate({"global_crops": g, "other": 1})
    assert ann["other"] == 1 and ann["teacher_cls"].shape == (4, 96)
    assert ann["teacher_patches"].shape == (4, srv.patch_grid ** 2, 96)
    assert srv.teacher_forwards - base == 4
    again = srv.annotate({"global_crops": g})
    assert srv.teacher_forwards - base == 4
    for k in ("teacher_cls", "teacher_patches"):
        assert np.array_equal(ann[k], again[k])
    fresh = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    before = srv.teacher_forwards
    dup = srv.annotate({"global_crops": np.concatenate([fresh, fresh])})
    assert srv.teacher_forwards - before == 2
    assert np.array_equal(dup["teacher_patches"][:2], dup["teacher_patches"][2:])
    s = srv.stats()
    assert s["compile_count"] == 1 and s["teacher_forwards"] < s["requests"]
    assert s["cache"]["hits"] >= 4


def test_shared_teacher_server_is_one_object_per_teacher(dworld):
    """Two students of the same teacher get the same server; other weights
    or another checkpoint another one."""
    from dinov3_tpu_torch.train.multidistillation import _SHARED_TEACHERS, shared_teacher_server

    w = dworld
    sd = w["tmeta"].teacher["backbone"].state_dict()
    _SHARED_TEACHERS.clear()
    try:
        a = shared_teacher_server(w["tcfg"], teacher_params=sd, warn=False, device="cpu")
        other_student = port_cfg([
            "student.arch=vit_test_big", "dino.head_hidden_dim=48", "ibot.head_hidden_dim=48",
            *distill(w["tcfg"].distillation.full_cfg_path, "serve")])
        b = shared_teacher_server(other_student, teacher_params=sd, warn=False, device="cpu")
        assert a is b
        g = np.random.default_rng(11).standard_normal((3, 16, 16, 3)).astype(np.float32)
        base = a.teacher_forwards
        a.annotate({"global_crops": g})
        b.annotate({"global_crops": g})
        assert a.teacher_forwards - base == 3 and a.engine.compile_count == 1
        c = shared_teacher_server(w["tcfg"], teacher_params={k: v + 1e-3 for k, v in sd.items()},
                                  warn=False, device="cpu")
        assert c is not a and c.fingerprint != a.fingerprint
        assert shared_teacher_server(w["tcfg"], teacher_params=sd, warn=False,
                                     device="cpu") is a
    finally:
        _SHARED_TEACHERS.clear()


# ---------------- loads ----------------

def _jax_train_state(jcfg, jmeta, params, step: int):
    import jax
    import jax.numpy as jnp

    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState

    opt = build_optimizer(jcfg, params["student"], jsched(jcfg))
    return TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                      jmeta.init_state(), jnp.asarray(step, jnp.int32))


def _jax_local_save(directory, jstate, step: int) -> None:
    """The JAX package's local-npz save (``Checkpointer._local_save``)."""
    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer

    ckpt = JaxCheckpointer(str(directory), async_save=False, max_to_keep=5)
    try:
        ckpt._local_save(step, jstate)
    finally:
        ckpt.close()


def test_load_teacher_params_from_a_port_and_a_jax_local_checkpoint(dworld, teacher_yaml,
                                                                    tmp_path):
    """The teacher branch (backbone and heads) of a teacher run's
    checkpoint, this package's or the JAX package's local-npz one, loads
    bitwise into the frozen teacher; the student stays; an orbax
    directory is refused by name."""
    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import build_train_setup
    from dinov3_tpu_torch.train.distillation import load_teacher_params

    w = dworld
    t_cfg = load_config(teacher_yaml)  # the teacher's own run
    t_setup = build_train_setup(t_cfg, make_synthetic_batch(t_cfg, 2, seed=0), device="cpu",
                                seed=4)
    with torch.no_grad():
        for p in t_setup.meta.teacher.parameters():
            p.add_(0.01)
    Checkpointer(str(tmp_path / "port")).save(3, t_setup.state)
    cfg = port_cfg(distill(teacher_yaml) + [f"distillation.checkpoint_path={tmp_path / 'port'}"])
    setup = build_train_setup(cfg, make_synthetic_batch(cfg, B, seed=1), device="cpu", seed=5)
    student = {k: v.clone() for k, v in setup.meta.student.state_dict().items()}
    load_teacher_params(cfg, setup.state)
    _equal_sd(setup.meta.teacher.state_dict(), t_setup.meta.teacher.state_dict())
    _equal_sd(setup.meta.student.state_dict(), student)
    # a JAX local-npz checkpoint of a run whose teacher is the distillation teacher's arch
    jparams = {"student": w["params"]["teacher"], "teacher": _noisy(w["params"]["teacher"], 9)}
    _jax_local_save(tmp_path / "jax", _jax_train_state(w["jcfg"], w["jmeta"], jparams, 4), 4)
    cfg.distillation.checkpoint_path = str(tmp_path / "jax")
    load_teacher_params(cfg, setup.state)
    want = meta_state_dicts_from_jax({"t": jparams["teacher"]})["t"]
    _equal_sd(setup.meta.teacher.state_dict(), want)
    (tmp_path / "orbax" / "5" / "state").mkdir(parents=True)
    cfg.distillation.checkpoint_path = str(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match="orbax.*M5"):
        load_teacher_params(cfg, setup.state)
    cfg.distillation.checkpoint_path = ""
    assert load_teacher_params(cfg, setup.state) is setup.state


def test_train_state_from_jax_carries_a_distillation_state(dworld, tmp_path):
    """A JAX distillation ``TrainState`` (a ``vit_test`` student, a
    ``vit_test_big`` teacher with its own heads) saved as local-npz and
    restored whole into the port's distillation state: student, teacher,
    moments, count and step bitwise."""
    from dinov3_tpu_torch.checkpoint import restore_jax_local
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.interop.from_jax import train_state_from_jax
    from dinov3_tpu_torch.train import build_train_setup

    w = dworld
    jstate = _jax_train_state(w["jcfg"], w["jmeta"], w["params"], 3)
    _jax_local_save(tmp_path, jstate, 3)
    with np.load(tmp_path / "3" / "state.npz") as z:
        payload = train_state_from_jax({k: z[k] for k in z.files})
    want = meta_state_dicts_from_jax(w["params"])
    assert payload["teacher"]["backbone.cls_token"].shape[-1] == 96
    assert payload["teacher"]["dino_head.mlp.0.weight"].shape == (48, 96)
    setup = build_train_setup(w["tcfg"], w["batch"], device="cpu", seed=12)
    state = restore_jax_local(str(tmp_path), setup.state)
    assert state.step == 3 and state.opt_state.count == 0
    _equal_sd(state.meta.student.state_dict(), want["student"])
    _equal_sd(state.meta.teacher.state_dict(), want["teacher"])
    names = [n for n, _ in state.meta.student.named_parameters()]
    assert all(torch.equal(m, payload["mu"][n]) for n, m in zip(names, state.opt_state.mu))


@pytest.fixture(scope="module")
def warm_world(tmp_path_factory):
    """A source run (its dino head at 32 prototypes, so those leaves do not
    match) saved by the JAX package as orbax (for JAX's loader) and as
    local-npz (for the port's), and a target run's JAX params."""
    import jax

    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    prev = get_current_mesh()
    set_current_mesh(None)
    d = tmp_path_factory.mktemp("warm")
    metas = {}
    for name, extra, seeds in (("src", ["dino.head_n_prototypes=32"], (11, 12)),
                               ("dst", [], (13, 14))):
        jcfg, _ = cfgs(extra)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmeta = JMeta(jcfg)
        batch = {k: np.asarray(v) for k, v in make_synthetic_batch(jcfg, B, seed=0).items()}
        p = jax.tree.map(np.asarray, jmeta.init_params(jax.random.key(0), batch))
        metas[name] = (jcfg, jmeta, {k: _noisy(p[k], s) for k, s in zip(("student", "teacher"),
                                                                     seeds)})
    jcfg, jmeta, src = metas["src"]
    jstate = _jax_train_state(jcfg, jmeta, src, 2)
    ckpt = JaxCheckpointer(str(d / "orbax"), async_save=False)
    try:
        ckpt.save(2, jstate)
    finally:
        ckpt.close()
    _jax_local_save(d / "npz", jstate, 2)
    set_current_mesh(prev)
    return d, metas


@pytest.mark.parametrize("key", ["pretrained_weights", "resume_from_teacher_chkpt"])
def test_load_pretrained_weights_matches_jax(warm_world, key, _no_ambient_mesh):
    """Each warm-start key against JAX's ``load_pretrained_weights`` on the
    same checkpoint: the chosen branch into the student where names and
    shapes match (the 32-prototype head keeps its values), the teacher
    mirroring the student; both keys together raise on both sides."""
    import jax

    from dinov3_tpu.train.pretrained import load_pretrained_weights as jload

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import SSLMetaArch
    from dinov3_tpu_torch.train.pretrained import load_pretrained_weights

    d, metas = warm_world
    jcfg, jmeta, dst = metas["dst"]
    jcfg = copy.deepcopy(jcfg)
    jcfg.student[key] = str(d / "orbax")
    jstate = _jax_train_state(jcfg, jmeta, dst, 0)
    device = jax.devices()[0]
    shardings = types.SimpleNamespace(params=jax.tree.map(
        lambda _: jax.sharding.SingleDeviceSharding(device), jstate.params))
    want = meta_state_dicts_from_jax(jax.tree.map(
        np.asarray, jload(jcfg, jstate, shardings).params))
    tcfg = port_cfg([f"student.{key}={d / 'npz'}"])
    tmeta = SSLMetaArch(tcfg)
    _load(tmeta, dst)
    state = types.SimpleNamespace(meta=tmeta)
    assert load_pretrained_weights(tcfg, state) is state
    _equal_sd(tmeta.student.state_dict(), want["student"])
    _equal_sd(tmeta.teacher.state_dict(), want["teacher"])
    kept = meta_state_dicts_from_jax(dst)["student"]["dino_head.last_layer.weight"]
    assert torch.equal(tmeta.student.state_dict()["dino_head.last_layer.weight"], kept)
    other = "resume_from_teacher_chkpt" if key == "pretrained_weights" else "pretrained_weights"
    jcfg.student[other] = str(d / "orbax")
    tcfg.student[other] = str(d / "npz")
    with pytest.raises(ValueError) as jerr:
        jload(jcfg, jstate, shardings)
    with pytest.raises(ValueError) as terr:
        load_pretrained_weights(tcfg, state)
    assert "mutually exclusive" in str(terr.value) and "mutually exclusive" in str(jerr.value)


def test_restore_params_only_matches_jax(warm_world, tmp_path, _no_ambient_mesh):
    """``Checkpointer.restore_params_only`` (hrft's load): from a JAX
    local-npz directory the same parameters as JAX's own
    ``restore_params_only``; from this package's checkpoint the saved
    parameters; the optimizer, centers and step stay fresh on both."""
    import jax

    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer

    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import build_train_setup

    d, metas = warm_world
    jcfg, jmeta, dst = metas["dst"]
    jck = JaxCheckpointer(str(d / "npz"), async_save=False)
    jck.manager.close()
    jck.manager, jck._local = None, True  # the local-npz backend (tests/test_distillation.py)
    jrest = jck.restore_params_only(_jax_train_state(jcfg, jmeta, dst, 0))
    jck.close()
    assert int(jrest.step) == 0
    want = meta_state_dicts_from_jax(jax.tree.map(np.asarray, jrest.params))
    tcfg = port_cfg(["dino.head_n_prototypes=32"])
    batch = make_synthetic_batch(tcfg, B, seed=1)
    setup = build_train_setup(tcfg, batch, device="cpu", seed=6)
    state = Checkpointer(str(d / "npz")).restore_params_only(setup.state)
    _equal_sd(state.meta.student.state_dict(), want["student"])
    _equal_sd(state.meta.teacher.state_dict(), want["teacher"])
    assert state.step == 0 and state.opt_state.count == 0
    assert not any(m.any() for m in state.opt_state.mu)
    # this package's checkpoint: a stepped state's parameters, nothing else
    state, _ = setup.step_fn(state, batch, setup.scalars(0))
    Checkpointer(str(tmp_path)).save(1, state)
    fresh = build_train_setup(tcfg, batch, device="cpu", seed=7)
    Checkpointer(str(tmp_path)).restore_params_only(fresh.state)
    _equal_sd(fresh.meta.student.state_dict(), state.meta.student.state_dict())
    _equal_sd(fresh.meta.teacher.state_dict(), state.meta.teacher.state_dict())
    assert fresh.state.step == 0 and fresh.state.opt_state.count == 0


# ---------------- multidistillation ----------------

def test_multidistillation_routing_matches_jax(tmp_path):
    """``enumerate_subgroup_ranks`` and ``setup_multidistillation`` against
    the JAX package's: the same assignments over 4 ranks and over 1, the
    same refusals of an empty span and of spans that do not partition
    the world."""
    from dinov3_tpu.configs import apply_dot_overrides as japply
    from dinov3_tpu.configs import get_default_config as jdefault
    from dinov3_tpu.train import multidistillation as J

    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.train import multidistillation as T

    spans = [(0, 2), (2, 3)]
    assert T.enumerate_subgroup_ranks(spans) == J.enumerate_subgroup_ranks(spans) == (
        (0, 1), (2,))
    for bad in ([(3, 3)], [(1, 0)]):
        with pytest.raises(ValueError, match="empty rank span"):
            T.enumerate_subgroup_ranks(bad)
    student = write_yaml(tmp_path / "s.yaml", {"student": {"arch": "vit_test", "patch_size": 4},
                                               "optim": {"scaling_rule": "none"}})
    over = ["multidistillation.enabled=true", "multidistillation.global_batch_size=8",
            "distillation.teacher_source=serve"]
    cfgs_ = (jdefault(), get_default_config())
    japply(cfgs_[0], over)
    apply_dot_overrides(cfgs_[1], over)
    for world, ranges in ((4, [[0, 2], [2, 4]]), (1, [[0, 1]])):
        for c in cfgs_:
            c.multidistillation.students = [
                {"name": f"s{i}", "config_path": student, "ranks_range": r}
                for i, r in enumerate(ranges)]
        for rank in range(world):
            a, b = (m.setup_multidistillation(c, rank, world, str(tmp_path / "out"),
                                              extra_overrides=["crops.local_crops_number=2"])
                    for m, c in ((J, cfgs_[0]), (T, cfgs_[1])))
            assert (a.name, a.index, a.group_ranks, a.group_rank, a.output_dir) == (
                b.name, b.index, b.group_ranks, b.group_rank, b.output_dir)
            for key in ("train.batch_size_per_device", "student.arch", "train.output_dir",
                        "crops.local_crops_number", "distillation.teacher_source"):
                x, y = a.cfg, b.cfg
                for part in key.split("."):
                    x, y = x[part], y[part]
                assert x == y, key
    for c in cfgs_:
        c.multidistillation.students[0]["ranks_range"] = [0, 2]
    with pytest.raises(ValueError) as want:
        J.setup_multidistillation(cfgs_[0], 0, 1, str(tmp_path))
    with pytest.raises(ValueError) as got:
        T.setup_multidistillation(cfgs_[1], 0, 1, str(tmp_path))
    assert str(got.value) == str(want.value) and "partition" in str(got.value)


# ---------------- the trainer ----------------

CLI_THREADS = 2


def run_cli(out_dir, *args, extra=()) -> dict:
    """``python -m dinov3_tpu_torch.train.train`` in a child process on
    the CPU; its result is the last line of its output."""
    env = dict(os.environ, OMP_NUM_THREADS=str(CLI_THREADS))
    cmd = [sys.executable, "-m", "dinov3_tpu_torch.train.train", "--output-dir", str(out_dir),
           *map(str, args), "MODEL.DEVICE=cpu", *SMOL, f"train.batch_size_per_device={B}",
           "checkpointing.period=2", *extra]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_distils_on_the_serve_arm_from_a_teacher_checkpoint_and_resumes(teacher_yaml,
                                                                           tmp_path):
    """The trainer with a teacher checkpoint written here and
    ``teacher_source=serve``: 4 iterations saving at 2 and 4, every batch
    annotated (the first and the next batch of each iteration), the
    teacher frozen at the checkpoint's; a resume from the step-2 save in a
    new process gives the same losses (``--ref-losses``) and the same
    step-4 state bit for bit; the self-check reports the frozen
    teacher."""
    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    t_cfg = load_config(teacher_yaml)
    t_setup = build_train_setup(t_cfg, make_synthetic_batch(t_cfg, 2, seed=0), device="cpu",
                                seed=8)
    Checkpointer(str(tmp_path / "teacher")).save(1, t_setup.state)
    extra = distill(teacher_yaml, "serve") + [
        f"distillation.checkpoint_path={tmp_path / 'teacher'}"]
    a = run_cli(tmp_path / "a", "--max-iterations", 4, "--record-losses", tmp_path / "a.jsonl",
                extra=extra)
    assert a["distillation"] == "serve" and a["iterations"] == 4
    assert [s["step"] for s in a["saves"]] == [2, 4]
    ts = a["teacher_serve"]
    assert ts["requests"] == 5 * 2 * B and ts["compile_count"] == 1
    assert 0 < ts["teacher_forwards"] <= ts["requests"]

    def payload(run, step):
        return torch.load(tmp_path / run / "ckpt" / str(step) / "state.pt",
                          map_location="cpu", weights_only=True)

    _equal_sd(payload("a", 4)["teacher"], t_setup.meta.teacher.state_dict())
    shutil.copytree(tmp_path / "a" / "ckpt" / "2", tmp_path / "r" / "ckpt" / "2")
    r = run_cli(tmp_path / "r", "--max-iterations", 4, "--ref-losses", tmp_path / "a.jsonl",
                extra=extra)
    assert r["start_iteration"] == 2 and r["iterations"] == 4 and r["loss_divergences"] == 0
    assert r["teacher_serve"]["requests"] == 3 * 2 * B
    wa, wr = payload("a", 4), payload("r", 4)
    for key in ("student", "teacher", "mu", "nu"):
        _equal_sd(wr[key], wa[key])
    sc = run_cli(tmp_path / "sc", "--self-check", extra=extra)
    assert sc["self_check_failures"] == 0 and sc["check/distillation_teacher_frozen"] is True
    assert not any(k.startswith("check/teacher_ema_moves") for k in sc)


# ---------------- on the card ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_served_teacher_features_match_the_in_step_teacher_on_the_card(cuda_device, tmp_path):
    """A 2-block ViT-S/16 teacher (head_dim 64, bf16) on the card: the
    ``TeacherServer``'s planes (the packed engine, K1 with segment ids)
    against the in-step teacher's features (K1 without), within 2^-5 of the
    largest feature magnitude; a replay is bitwise."""
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.ops.flash_attention import FLASH_FWD
    from dinov3_tpu_torch.train import SSLMetaArch, put_batch
    from dinov3_tpu_torch.train.distillation import TeacherServer

    recipe = teacher_recipe("vit_small", hidden=48, dtype="bf16", n_blocks=2)
    recipe["student"]["patch_size"] = 16
    path = write_yaml(tmp_path / "t.yaml", recipe)
    cfg = port_cfg(distill(path, "serve") + [
        "student.patch_size=16", "crops.global_crops_size=64", "crops.local_crops_size=32"])
    meta = SSLMetaArch(cfg, seed=0, teacher_device=cuda_device).to(cuda_device)
    batch = make_synthetic_batch(cfg, B, seed=3)
    cls, patches = meta.teacher_backbone_features(put_batch(batch, cuda_device))
    before = FLASH_FWD.launches
    srv = TeacherServer(cfg, teacher_params=meta.teacher["backbone"].state_dict(), warn=False,
                        device=cuda_device)
    ann = srv.annotate(batch)
    assert FLASH_FWD.launches > before and srv.stats()["compile_count"] == 1
    for got, want in ((ann["teacher_cls"], cls), (ann["teacher_patches"], patches)):
        want = want.float().cpu().numpy()
        np.testing.assert_allclose(got, want, atol=BF16_FEATURES * np.abs(want).max())
    again = srv.annotate(batch)
    assert srv.teacher_forwards == 2 * B
    assert np.array_equal(again["teacher_patches"], ann["teacher_patches"])
