"""The port's training slice against the JAX package, fp32 on the CPU at
``vit_test`` size (the ``SMOL`` overrides of ``tests/test_crop_packing.py``
with the materialized targets, drop path 0.3, and the JAX attention
running the Pallas flash kernel in interpret mode, as the port's attention
always runs K1-K3, here their plain versions).

Inputs are made with numpy from a seed, weights are JAX's (perturbed so
zero-initialised leaves count) bridged by ``interop/from_jax.py``, and the
drop-path plan is JAX's own, handed across as numpy.

Tolerances:
- layouts, masks, batches, schedules, multipliers and plans: exact;
- single ops and losses: 1e-5 relative (fp32 sums in other orders);
- the meta-arch loss terms: 1e-5 relative; every student gradient leaf:
  1e-4 of that leaf's largest magnitude (a ViT forward and backward of
  fp32 ops whose sums run in other orders);
- the optimizer on identical gradients: 1e-6 of each leaf's scale (scalar
  factors rounded in another order, p - lr * d cancelling to near 0);
- three steps (see that test): loss terms 1e-4 relative, and the teacher
  within the bound that Adam's sign-like first steps allow.
"""

import warnings

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    "optim.warmup_epochs=1", "optim.freeze_last_layer_epochs=1",
    "compute_precision.compute_dtype=fp32",
    "optim.scaling_rule=none",
    "loss.streaming_targets=false",
    "kernels.flash_attention=pallas",
]
B = 4


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


def cfgs(extra=()):
    """(JAX cfg, port cfg) from the same overrides."""
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default

    jcfg, tcfg = get_default_config(), t_default()
    apply_dot_overrides(jcfg, SMOL + list(extra))
    t_apply(tcfg, SMOL + list(extra))
    return jcfg, tcfg


def _noisy(tree, seed, scale=0.05):
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])


@pytest.fixture(scope="module")
def world():
    """The JAX meta-arch with perturbed weights, one batch, and the port's
    meta-arch holding the same weights."""
    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import SSLMetaArch

    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    jcfg, tcfg = cfgs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    batch = make_synthetic_batch(jcfg, B, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray,
                          jmeta.init_params(jax.random.key(0), jbatch))
    params = {"student": _noisy(params["student"], 1),
              "teacher": _noisy(params["teacher"], 2)}
    tmeta = SSLMetaArch(tcfg)
    sds = meta_state_dicts_from_jax(params)
    tmeta.student.load_state_dict(sds["student"])
    tmeta.teacher.load_state_dict(sds["teacher"])
    set_current_mesh(prev)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmeta": jmeta, "tmeta": tmeta,
            "batch": batch, "jbatch": jbatch, "params": params}


def _jax_plan(jmeta, jbatch, it, seed=5):
    plan = jmeta.build_rng_plan(
        jax.random.fold_in(jax.random.key(seed), it), jbatch)["packed"]
    return jax.tree.map(np.asarray, plan)


def _np(t):
    return t.detach().float().numpy()


# ---------------- host data ----------------

def test_synthetic_batch_is_bitwise_the_jax_batch():
    from dinov3_tpu.data import make_synthetic_batch as jax_batch

    from dinov3_tpu_torch.data import make_synthetic_batch

    for extra in ([], ["ibot.mask_random_circular_shift=true"]):
        jcfg, tcfg = cfgs(extra)
        for seed in (0, (3, 1, 7)):
            want, got = jax_batch(jcfg, B, seed=seed), make_synthetic_batch(tcfg, B, seed=seed)
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------- the drop-path plan ----------------

@pytest.mark.parametrize("rows,rate", [(11, 0.3), (116, 0.3), (5, 0.5)])
def test_port_plan_builder_shapes_sorted_unique_in_range(rows, rate):
    from dinov3_tpu_torch.ops.drop_path import subset_keep_count
    from dinov3_tpu_torch.rng import packed_pass_plan, step_generator

    L = 3
    plan = packed_pass_plan(step_generator(0, 4), L, rows, rate)
    idx = plan["drop_path"]["idx"]
    keep = subset_keep_count(rows, rate)
    assert keep == max(1, int(rows * (1 - rate)))
    assert idx.shape == (L, 2, keep) and idx.dtype == torch.int64
    assert (idx[..., 1:] > idx[..., :-1]).all()       # sorted and unique
    assert (idx >= 0).all() and (idx < rows).all()
    again = packed_pass_plan(step_generator(0, 4), L, rows, rate)
    assert torch.equal(again["drop_path"]["idx"], idx)  # (seed, iteration) keyed
    other = packed_pass_plan(step_generator(0, 5), L, rows, rate)
    assert not torch.equal(other["drop_path"]["idx"], idx)
    assert packed_pass_plan(step_generator(0, 4), L, rows, 0.0) == {}
    mask = packed_pass_plan(step_generator(0, 4), L, rows, rate, mode="mask")
    assert mask["drop_path"]["keep"].shape == (L, 2, rows)


def test_port_plan_matches_the_jax_plan_structure(world):
    from dinov3_tpu_torch.rng import packed_pass_plan, step_generator
    from dinov3_tpu_torch.ops.packing import packed_layout

    jplan = _jax_plan(world["jmeta"], world["jbatch"], 0)
    rows = packed_layout(world["tcfg"], world["batch"]).rows_total
    plan = packed_pass_plan(step_generator(0, 0), 2, rows, 0.3)
    assert plan.keys() == jplan.keys()
    assert tuple(plan["drop_path"]["idx"].shape) == jplan["drop_path"]["idx"].shape


# ---------------- heads and losses ----------------

def test_dino_head_matches_jax():
    from dinov3_tpu.ops import DINOHead as JHead

    from dinov3_tpu_torch.interop import head_state_dict_from_jax
    from dinov3_tpu_torch.ops.dino_head import DINOHead

    x = np.random.default_rng(0).standard_normal((6, 16)).astype(np.float32)
    x[0] = 0.0  # a zero row: the zero-safe L2 norm keeps it finite
    for nlayers in (1, 3):
        jm = JHead(out_dim=40, hidden_dim=24, bottleneck_dim=8,
                   nlayers=nlayers, dtype=jnp.float32)
        params = _noisy(nn.meta.unbox(
            jm.init(jax.random.key(0), jnp.asarray(x))["params"]), 3)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
        tm = DINOHead(16, 40, hidden_dim=24, bottleneck_dim=8,
                      nlayers=nlayers, dtype=torch.float32)
        tm.load_state_dict(head_state_dict_from_jax(params))
        got = tm(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_l2_normalize_matches_jax_and_is_zero_safe():
    from dinov3_tpu.ops.common import l2_normalize as jl2

    from dinov3_tpu_torch.ops.common import l2_normalize

    x = np.random.default_rng(1).standard_normal((4, 7)).astype(np.float32)
    x[1] = 0.0
    t = torch.from_numpy(x).requires_grad_()
    y = l2_normalize(t)
    np.testing.assert_allclose(_np(y), np.asarray(jl2(jnp.asarray(x))), rtol=1e-6)
    y.sum().backward()
    assert torch.isfinite(t.grad).all()


@pytest.mark.parametrize("with_weights", [False, True])
def test_sinkhorn_matches_jax(with_weights):
    from dinov3_tpu.losses import sinkhorn_knopp as jsk

    from dinov3_tpu_torch.losses import sinkhorn_knopp

    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((12, 64)) * 3).astype(np.float32)
    w = (np.arange(12) % 4 != 3).astype(np.float32) if with_weights else None
    want = np.asarray(jsk(jnp.asarray(logits), 0.07,
                          row_weights=None if w is None else jnp.asarray(w)))
    got = sinkhorn_knopp(torch.from_numpy(logits), 0.07,
                         row_weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-7)


def test_dino_ibot_koleo_losses_match_jax():
    from dinov3_tpu.losses import koleo_loss as jkoleo
    from dinov3_tpu.losses.dino_loss import dino_pair_ce as jpair
    from dinov3_tpu.losses.dino_loss import pair_ce_to_loss as jto
    from dinov3_tpu.losses.ibot_loss import ibot_patch_loss_masked as jibot

    from dinov3_tpu_torch.losses import (
        dino_pair_ce,
        ibot_patch_loss_masked,
        koleo_loss,
        pair_ce_to_loss,
    )

    rng = np.random.default_rng(3)
    s = rng.standard_normal((4, 3, 64)).astype(np.float32)
    q = rng.dirichlet(np.ones(64), size=(2, 3)).astype(np.float32)
    want = np.asarray(jpair(jnp.asarray(s), jnp.asarray(q)))
    got = dino_pair_ce(torch.from_numpy(s), torch.from_numpy(q))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5)
    for diag in (False, True):
        np.testing.assert_allclose(
            float(pair_ce_to_loss(got[:2], 3, ignore_diagonal=diag)),
            float(jto(jnp.asarray(want[:2]), 3, ignore_diagonal=diag)), rtol=1e-5)
    x = rng.standard_normal((10, 64)).astype(np.float32)
    qm = rng.dirichlet(np.ones(64), size=10).astype(np.float32)
    qm[7:] = 0.0
    w = np.array([0.5] * 4 + [1 / 3] * 3 + [0.0] * 3, np.float32)
    np.testing.assert_allclose(
        float(ibot_patch_loss_masked(*(torch.from_numpy(a) for a in (x, qm, w)), 4)),
        float(jibot(*(jnp.asarray(a) for a in (x, qm, w)), 4)), rtol=1e-5)
    f = rng.standard_normal((8, 16)).astype(np.float32)
    for topk, group in ((1, None), (2, 4)):
        np.testing.assert_allclose(
            float(koleo_loss(torch.from_numpy(f), topk=topk, group_size=group)),
            float(jkoleo(jnp.asarray(f), topk=topk, group_size=group)), rtol=1e-5)


# ---------------- schedules, multipliers, update ----------------

def test_schedules_match_jax():
    from dinov3_tpu.train.schedules import build_schedules as jsched

    from dinov3_tpu_torch.train.schedules import build_schedules

    jcfg, tcfg = cfgs()
    want, got = jsched(jcfg), build_schedules(tcfg)
    for name in ("lr", "weight_decay", "momentum", "teacher_temp", "last_layer_lr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.at(3) == want.at(3)


def test_multipliers_match_jax(world):
    """The JAX multiplier trees, each leaf broadcast to its parameter's
    shape and bridged to the port's names, against the port's
    name-based multipliers."""
    from dinov3_tpu.train.param_groups import build_multiplier_trees

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train.param_groups import build_multipliers

    student = world["params"]["student"]
    kw = dict(layerwise_decay=0.9, patch_embed_lr_mult=0.2,
              dino_head_wd_multiplier=0.5)
    trees = build_multiplier_trees(student, **kw)
    bridged = [meta_state_dicts_from_jax({"s": jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), tree, student)})["s"]
        for tree in trees]
    ours = build_multipliers(bridged[0].keys(), **kw)
    assert ours.keys() == set(world["tmeta"].student.state_dict())
    for name, m in ours.items():
        assert np.allclose(bridged[0][name].numpy(), m.lr, rtol=1e-6), name
        assert np.allclose(bridged[1][name].numpy(), m.wd), name
        assert bool(bridged[2][name].numpy().all()) == m.is_last_layer, name


def test_update_and_ema_match_jax_on_identical_grads(world):
    """Two clip + AdamW + EMA updates from identical gradients: the port's
    ``ScheduledAdamW`` against the JAX fused engine
    (``make_fused_update``, held equal to its optax oracle by
    ``tests/test_fused_update.py``). Iterations 1 and 2 of the schedule,
    where lr > 0."""
    import copy

    from dinov3_tpu.train.fused_update import build_fused_update
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
    from dinov3_tpu_torch.train.schedules import build_schedules

    jcfg, tcfg = world["jcfg"], world["tcfg"]
    params = world["params"]
    sched = jsched(jcfg)
    fused = build_fused_update(jcfg, params["student"], sched, ema=True)
    opt_state = build_optimizer(jcfg, params["student"], sched).init(
        params["student"])
    one = jnp.asarray(1, jnp.int32)  # start at iteration 1, where lr > 0
    opt_state = opt_state._replace(count=one,
                                   adam=opt_state.adam._replace(count=one))
    tmeta = copy.deepcopy(world["tmeta"])
    o = tcfg.optim
    topt = ScheduledAdamW(tmeta.student, build_schedules(tcfg),
                          layerwise_decay=o.layerwise_decay,
                          patch_embed_lr_mult=o.patch_embed_lr_mult,
                          dino_head_wd_multiplier=o.dino_head_wd_multiplier,
                          clip_grad=o.clip_grad)
    tstate = topt.init_state(tmeta.student)
    tstate.count = 1
    student, teacher = params["student"], params["teacher"]
    for i, scale in enumerate((1.0, 30.0)):  # the second one clips
        grads = _noisy(jax.tree.map(np.zeros_like, student), 10 + i, scale)
        student, teacher, opt_state, norms = fused(
            grads, student, teacher, opt_state, jnp.float32(0.99))
        sd = meta_state_dicts_from_jax({"g": grads})["g"]
        for n, p in tmeta.student.named_parameters():
            p.grad = sd[n]
        tnorms = topt.update(tmeta.student, tmeta.teacher, tstate, 0.99)
        for k in norms:
            np.testing.assert_allclose(float(tnorms[k]), float(norms[k]), rtol=1e-6)
    want = meta_state_dicts_from_jax(
        jax.tree.map(np.asarray, {"student": student, "teacher": teacher}))
    for role in ("student", "teacher"):
        got = getattr(tmeta, role).state_dict()
        for n, w in want[role].items():
            w = w.numpy()
            np.testing.assert_allclose(_np(got[n]), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{role} {n}")
    mu = meta_state_dicts_from_jax({"m": jax.tree.map(np.asarray, opt_state.adam.mu)})["m"]
    for (n, _), m in zip(tmeta.student.named_parameters(), tstate.mu):
        w = mu[n].numpy()
        np.testing.assert_allclose(_np(m), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max(), err_msg=n)


def test_meta_update_ema_matches_jax(world):
    import copy

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax

    params = world["params"]
    want = world["jmeta"].update_ema(params["teacher"], params["student"],
                                     jnp.float32(0.9))
    tmeta = copy.deepcopy(world["tmeta"])
    tmeta.update_ema(0.9)
    want = meta_state_dicts_from_jax({"t": jax.tree.map(np.asarray, want)})["t"]
    for n, p in tmeta.teacher.state_dict().items():
        np.testing.assert_allclose(_np(p), want[n].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)


# ---------------- the meta-arch and the step ----------------

LOSSES = ("dino_local_crops_loss", "dino_global_crops_loss", "koleo_loss",
          "ibot_loss", "total_loss")


def test_meta_forward_and_every_student_grad_match_jax(world):
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.rng import plan_to_device
    from dinov3_tpu_torch.train import put_batch

    jmeta, tmeta, jbatch = world["jmeta"], world["tmeta"], world["jbatch"]
    params = world["params"]
    plan = _jax_plan(jmeta, jbatch, 0)

    def loss(student):
        total, (d, _) = jmeta.forward(
            student, {"teacher": params["teacher"]}, jbatch,
            teacher_temp=0.07, state=jmeta.init_state(),
            iteration=jnp.asarray(0, jnp.int32), rng_plan={"packed": plan})
        return total, d

    (jtotal, jd), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["student"])
    tmeta.student.zero_grad(set_to_none=True)
    total, d, _ = tmeta(put_batch(world["batch"], "cpu"), teacher_temp=0.07,
                        plan=plan_to_device(plan, "cpu"))
    total.backward()
    for k in LOSSES:
        np.testing.assert_allclose(float(d[k]), float(jd[k]), rtol=1e-5,
                                   err_msg=k)
    want = meta_state_dicts_from_jax(
        {"g": jax.tree.map(np.asarray, jgrads)})["g"]
    for n, p in tmeta.student.named_parameters():
        w = want[n].numpy()
        g = np.zeros_like(w) if p.grad is None else _np(p.grad)
        np.testing.assert_allclose(g, w, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=n)
    tmeta.student.zero_grad(set_to_none=True)


def test_three_fp32_steps_match_jax_make_train_step(world):
    """Three steps of the port's step against JAX ``make_train_step`` (the
    fused update) from the same state, batch and drop-path plans.

    Loss terms: 1e-4 relative at every step. The teacher after every
    step: Adam's first steps divide each gradient entry by its own size,
    so an entry whose gradient is at rounding-noise level can move by up
    to lr * lr_mult either way; through the EMA the teacher can then
    differ by (1 - m) * 2 * lr summed over the steps so far (lr_mult <= 1).
    The test bounds the teacher's difference by that, plus 1e-5 of the
    leaf's scale, and checks that most entries agree far more tightly."""
    import copy

    from dinov3_tpu.train.fused_update import build_fused_update
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState, make_train_step

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
    from dinov3_tpu_torch.train.schedules import build_schedules
    from dinov3_tpu_torch.train.train_step import TrainState as TState
    from dinov3_tpu_torch.train.train_step import make_train_step as t_make

    jcfg, tcfg, jmeta = world["jcfg"], world["tcfg"], world["jmeta"]
    params, jbatch = world["params"], world["jbatch"]
    sched = jsched(jcfg)
    opt = build_optimizer(jcfg, params["student"], sched)
    fused = build_fused_update(jcfg, params["student"], sched, ema=True)
    jstep = jax.jit(make_train_step(jmeta, opt, clip_grad=jcfg.optim.clip_grad,
                                    fused_update=fused))
    jstate = TrainState(jax.tree.map(jnp.asarray, params),
                        opt.init(params["student"]), jmeta.init_state(),
                        jnp.zeros((), jnp.int32))
    tmeta = copy.deepcopy(world["tmeta"])
    o = tcfg.optim
    tsched = build_schedules(tcfg)
    topt = ScheduledAdamW(tmeta.student, tsched,
                          layerwise_decay=o.layerwise_decay,
                          patch_embed_lr_mult=o.patch_embed_lr_mult,
                          dino_head_wd_multiplier=o.dino_head_wd_multiplier,
                          clip_grad=o.clip_grad)
    tstate = TState(meta=tmeta, opt_state=topt.init_state(tmeta.student))
    tstep = t_make(topt)
    bound = 0.0
    for i in range(3):
        s = sched.at(i)
        jstate, jm = jstep(jstate, jbatch,
                           {"teacher_temp": jnp.float32(s["teacher_temp"]),
                            "momentum": jnp.float32(s["momentum"])},
                           jax.random.key(5))
        tstate, tm = tstep(tstate, world["batch"],
                           {"teacher_temp": s["teacher_temp"],
                            "momentum": s["momentum"]},
                           plan=_jax_plan(jmeta, jbatch, i))
        for k in LOSSES:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        bound += (1 - float(s["momentum"])) * 2 * float(s["lr"])
        want = meta_state_dicts_from_jax(
            {"t": jax.tree.map(np.asarray, jstate.params["teacher"])})["t"]
        got = tmeta.teacher.state_dict()
        close = total = 0
        for n, w in want.items():
            w = w.numpy()
            err = np.abs(_np(got[n]) - w)
            tol = 1e-5 * max(np.abs(w).max(), 1e-3)
            assert (err <= tol + bound).all(), (i, n, err.max(), tol + bound)
            close += int((err <= tol).sum())
            total += err.size
        assert close >= 0.99 * total, (i, close, total)
    assert tstate.step == 3 and tstate.opt_state.count == 3


# ---------------- setup ----------------

def test_build_train_setup_runs_a_step_and_refuses_the_cuts(world):
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    tcfg = world["tcfg"]
    batch = make_synthetic_batch(tcfg, B, seed=1)
    setup = build_train_setup(tcfg, batch, device="cpu", seed=3)
    state, m = setup.step_fn(setup.state, batch, setup.scalars(0))
    assert all(np.isfinite(m[k]) for k in LOSSES) and state.step == 1
    # the step draws its own plan, a pure function of (seed, iteration)
    again = build_train_setup(tcfg, batch, device="cpu", seed=3)
    _, m2 = again.step_fn(again.state, batch, again.scalars(0))
    assert m2 == m
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_train_setup(tcfg, batch)  # the default device is the card
    for bad, err in (("gram.use_loss=true", NotImplementedError),
                     ("parallel.fsdp=2", NotImplementedError),
                     ("model.crop_packing=sometimes", ValueError),
                     ("optim.accum_steps=3", ValueError)):
        cfg = get_default_config()
        apply_dot_overrides(cfg, SMOL + [bad])
        with pytest.raises(err):
            build_train_setup(cfg, make_synthetic_batch(cfg, B), device="cpu")
