"""The port's Gram anchor against the JAX package, on the CPU at test
widths: ``losses/gram_loss.py``, the grid resize (``ops/resize.py``
against ``jax.image.resize``), the refresh cadence and the Gram teacher's
refresh and load (``train/gram_refresh.py``), the meta-arch's Gram terms,
the checkpoint and the JAX bridge (the ``SMOL`` model of
``tests/test_torch_train.py``: ``vit_test``, 16 px global crops of 4 x 4
patches, 24 px Gram teacher crops of 6 x 6 patches resized onto them).

Inputs are made with numpy from a seed; weights are JAX's, perturbed,
bridged by ``interop/from_jax.py``.

Tolerances:
- the refresh arithmetic, the bridge, checkpoints and loads: exact;
- ``gram_loss`` in fp32, value and gradient: 1e-5 relative (of the
  gradient's largest magnitude); bf16 inputs reduced in fp32: 1e-5
  relative against JAX's bf16 inputs (both upcast the same bf16 values);
- the resize in fp32: 1e-5 absolute;
- the meta-arch's loss terms and every student gradient with the Gram
  loss on: those of ``test_meta_forward_and_every_student_grad_match_jax``
  (1e-5 relative; 1e-4 of each leaf's largest magnitude);
- three steps with a refresh: those of
  ``test_three_fp32_steps_match_jax_make_train_step`` (loss terms 1e-4
  relative; the teacher, and the Gram branch refreshed from it, within
  Adam's sign-step bound); the refreshed Gram branch equals the teacher
  bit for bit on each side;
- a resume in a new process across a refresh: bitwise.
"""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import B, _jax_plan, _noisy, _np, cfgs
from test_torch_trainer import load_ckpt, read_losses, run_cli

GRAM = ["gram.use_loss=true", "crops.gram_teacher_crops_size=24"]
LOSSES = ("dino_local_crops_loss", "dino_global_crops_loss", "koleo_loss",
          "ibot_loss", "gram_loss", "total_loss")


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    """The JAX side reads the process's current mesh; these single-device
    comparisons run without one (as in ``tests/test_torch_train.py``)."""
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


def gram_state_dict(jgram) -> dict:
    """A JAX ``params["gram"]`` -> the port's ``SSLMetaArch.gram`` state_dict."""
    from dinov3_tpu_torch.interop import state_dict_from_jax

    return {f"backbone.{k}": v for k, v in state_dict_from_jax(jgram["backbone"]).items()}


def gram_world(extra=()):
    """The JAX meta-arch with the Gram loss on and perturbed student,
    teacher and Gram weights (no Gram branch under ``gram.ema_teacher``),
    one batch, and the port's meta-arch holding the same weights."""
    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import SSLMetaArch

    jcfg, tcfg = cfgs(GRAM + list(extra))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    batch = make_synthetic_batch(jcfg, B, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jmeta.init_params(jax.random.key(0), jbatch))
    ema = bool(jcfg.gram.ema_teacher)
    assert set(params) == {"student", "teacher"} | (set() if ema else {"gram"})
    seeds = {"gram": 4, "student": 1, "teacher": 2}
    params = {k: _noisy(v, seeds[k]) for k, v in params.items()}
    tmeta = SSLMetaArch(tcfg)
    assert (tmeta.gram is None) == ema
    sds = meta_state_dicts_from_jax({k: params[k] for k in ("student", "teacher")})
    tmeta.student.load_state_dict(sds["student"])
    tmeta.teacher.load_state_dict(sds["teacher"])
    if not ema:
        tmeta.gram.load_state_dict(gram_state_dict(params["gram"]))
    return {"jcfg": jcfg, "tcfg": tcfg, "jmeta": jmeta, "tmeta": tmeta,
            "batch": batch, "jbatch": jbatch, "params": params}


# ---------------- the loss and the resize ----------------

GRAM_OPTIONS = [
    dict(),
    dict(img_level=False),
    dict(normalize=False),
    dict(remove_neg=True),
    dict(remove_only_teacher_neg=True),
    dict(img_level=False, remove_only_teacher_neg=True, mask=True),
    dict(img_level=False, normalize=False, remove_neg=True, mask=True),
]


@pytest.mark.parametrize("opts", GRAM_OPTIONS, ids=lambda o: "-".join(o) or "default")
def test_gram_loss_value_and_grad_match_jax(opts):
    from dinov3_tpu.losses.gram_loss import gram_loss as jax_gram_loss

    from dinov3_tpu_torch.losses import gram_loss

    opts = dict(opts)
    rng = np.random.default_rng(0)
    s = rng.standard_normal((3, 10, 8)).astype(np.float32)
    t = rng.standard_normal((3, 10, 8)).astype(np.float32)
    s[0, 1] = 0.0  # a zero token: the zero-safe normalisation keeps it finite
    mask = rng.random((3, 10)) < 0.5 if opts.pop("mask", False) else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(a):
        return jax_gram_loss(a, jnp.asarray(t), token_mask=jmask, **opts)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_(True)
    got = gram_loss(ts, torch.from_numpy(t),
                    token_mask=None if mask is None else torch.from_numpy(mask), **opts)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(ts.grad.numpy(), jgrad,
                               atol=1e-5 * max(np.abs(jgrad).max(), 1e-6))
    assert np.isfinite(ts.grad.numpy()).all()


def test_gram_loss_bf16_inputs_reduce_in_fp32_and_refuses_bad_options():
    from dinov3_tpu.losses.gram_loss import gram_loss as jax_gram_loss

    from dinov3_tpu_torch.losses import gram_loss

    rng = np.random.default_rng(1)
    s, t = (rng.standard_normal((2, 16, 32)).astype(np.float32) for _ in range(2))
    ts, tt = (torch.from_numpy(a).to(torch.bfloat16) for a in (s, t))
    got = gram_loss(ts, tt)
    want = jax_gram_loss(jnp.asarray(s, jnp.bfloat16), jnp.asarray(t, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="exclusive"):
        gram_loss(ts, tt, remove_neg=True, remove_only_teacher_neg=True)
    with pytest.raises(ValueError, match="img_level"):
        gram_loss(ts, tt, token_mask=torch.ones(2, 16, dtype=torch.bool))


@pytest.mark.parametrize("method", ["bicubic", "linear", "lanczos3", "nearest"])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_grid_matches_jax_image_resize(method, antialias):
    from dinov3_tpu_torch.ops.resize import resize_grid

    rng = np.random.default_rng(2)
    for h in (32, 24, 8):
        x = rng.standard_normal((2, h, h, 6)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 16, 16, 6),
                                           method=method, antialias=antialias))
        got = resize_grid(torch.from_numpy(x), (16, 16), method, antialias)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=str(h))


def test_resize_grid_is_not_torch_bicubic():
    """``F.interpolate(mode="bicubic")`` (a = -0.75, clamped borders)
    differs from JAX's resize on the recipe's 32 -> 16 downsampling."""
    import torch.nn.functional as F

    from dinov3_tpu_torch.ops.resize import resize_grid

    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 32, 32, 4))
                         .astype(np.float32))
    ours = resize_grid(x, (16, 16))
    theirs = F.interpolate(x.permute(0, 3, 1, 2), size=(16, 16), mode="bicubic",
                           align_corners=False).permute(0, 2, 3, 1)
    assert (ours - theirs).abs().max() > 1e-2


# ---------------- the refresh cadence ----------------

CADENCES = [
    dict(it_first_update=0, update_frequency=5, max_updates=None),
    dict(it_first_update=3, update_frequency=2, max_updates=2),
    dict(it_first_update=2, update_frequency=2, max_updates=1),
    dict(it_first_update=7, update_frequency=3, max_updates=None),
    dict(it_first_update=10, update_frequency=10, max_updates=3),
]


@pytest.mark.parametrize("switches", [(True, True, False), (True, False, False),
                                      (True, True, True), (False, True, False)])
def test_refresh_arithmetic_matches_jax(switches):
    from dinov3_tpu.train import gram_refresh as J

    from dinov3_tpu_torch.train import gram_refresh as T

    use_loss, rep_update, ema_teacher = switches
    for cadence in CADENCES:
        extra = [f"gram.use_loss={str(use_loss).lower()}",
                 f"gram.rep_update={str(rep_update).lower()}",
                 f"gram.ema_teacher={str(ema_teacher).lower()}"] + [
            f"gram.{k}={'null' if v is None else v}" for k, v in cadence.items()]
        jcfg, tcfg = cfgs(extra)
        for it in range(-1, 40):
            assert T.gram_updates_before(tcfg, it) == J.gram_updates_before(jcfg, it)
            for n in range(4):
                assert T.should_refresh_gram(tcfg, it, n) == J.should_refresh_gram(jcfg, it, n)


# ---------------- the meta-arch ----------------

@pytest.mark.parametrize("extra", [["gram.img_level=true"],
                                   ["gram.tokens_used=masked", "gram.compute_stats=true"],
                                   ["gram.ema_teacher=true", "gram.img_level=true"],
                                   ["gram.ema_teacher=true", "gram.img_level=false"]],
                         ids=["img_level", "masked", "ema_teacher-img_level", "ema_teacher"])
def test_meta_forward_and_every_student_grad_match_jax_with_gram(extra):
    """With ``gram.ema_teacher`` there is no Gram branch: the anchor is the
    EMA teacher's patches on both sides."""
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.rng import plan_to_device
    from dinov3_tpu_torch.train import put_batch

    w = gram_world(extra)
    jmeta, tmeta, jbatch, params = w["jmeta"], w["tmeta"], w["jbatch"], w["params"]
    plan = _jax_plan(jmeta, jbatch, 0)

    def loss(student):
        frozen = {k: params[k] for k in ("teacher", "gram") if k in params}
        total, (d, _) = jmeta.forward(
            student, frozen, jbatch,
            teacher_temp=0.07, state=jmeta.init_state(),
            iteration=jnp.asarray(0, jnp.int32), rng_plan={"packed": plan})
        return total, d

    (jtotal, jd), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["student"])
    total, d, _ = tmeta(put_batch(w["batch"], "cpu"), teacher_temp=0.07,
                        plan=plan_to_device(plan, "cpu"))
    total.backward()
    assert list(d) == tmeta.loss_names() and set(d) == set(jd)
    assert float(d["gram_loss"].detach()) > 0
    for k in d:
        np.testing.assert_allclose(float(d[k].detach()), float(jd[k]), rtol=1e-5, err_msg=k)
    want = meta_state_dicts_from_jax({"g": jax.tree.map(np.asarray, jgrads)})["g"]
    for n, p in tmeta.student.named_parameters():
        wg = want[n].numpy()
        g = np.zeros_like(wg) if p.grad is None else _np(p.grad)
        np.testing.assert_allclose(g, wg, atol=1e-4 * max(np.abs(wg).max(), 1e-6),
                                   err_msg=n)
    if tmeta.gram is not None:
        assert not any(p.requires_grad or p.grad is not None for p in tmeta.gram.parameters())


def test_gram_branch_starts_as_the_students_backbone_and_gets_no_optimizer_state():
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    tcfg = cfgs(GRAM)[1]
    batch = make_synthetic_batch(tcfg, B, seed=1)
    setup = build_train_setup(tcfg, batch, device="cpu", seed=3)
    meta = setup.meta
    student = meta.student["backbone"].state_dict()
    assert all(torch.equal(v, student[k]) for k, v in meta.gram["backbone"].state_dict().items())
    n_student = sum(1 for _ in meta.student.parameters())
    assert len(setup.state.opt_state.mu) == n_student
    before = {k: v.clone() for k, v in meta.gram.state_dict().items()}
    state, m = setup.step_fn(setup.state, batch, setup.scalars(0))
    assert np.isfinite(m["gram_loss"]) and m["gram_loss_weight"] == 1.0
    assert all(torch.equal(v, before[k]) for k, v in meta.gram.state_dict().items())
    # with gram.ema_teacher the anchor is the teacher's patches: no branch
    ema = cfgs(GRAM + ["gram.ema_teacher=true"])[1]
    setup = build_train_setup(ema, batch, device="cpu", seed=3)
    assert setup.meta.gram is None
    assert np.isfinite(setup.step_fn(setup.state, batch, setup.scalars(0))[1]["gram_loss"])


@pytest.mark.parametrize("extra", [[], [
    "student.n_storage_tokens=2", "student.untie_global_and_local_cls_norm=true",
    "student.untie_cls_and_patch_norms=true", "student.ffn_layer=swiglu64",
    "student.mask_k_bias=true", "student.layerscale=null", "student.norm_layer=rmsnorm"]],
    ids=["default", "7b-options"])
def test_every_parameter_is_drawn_or_loaded(monkeypatch, extra):
    """The meta-arch builds its modules without a default init pass
    (``_uninitialized``): filled with NaN before the seeded draws and the
    copies, no parameter of the student, the teacher or the Gram branch
    keeps one."""
    import dinov3_tpu_torch.train.ssl_meta_arch as M

    real = M._uninitialized

    def nan_filled(build, *args, **kwargs):
        module = real(build, *args, **kwargs)
        with torch.no_grad():
            for p in module.parameters():
                p.fill_(float("nan"))
        return module

    monkeypatch.setattr(M, "_uninitialized", nan_filled)
    meta = M.SSLMetaArch(cfgs(GRAM + extra)[1], seed=3)
    assert meta.gram is not None
    assert [n for n, p in meta.named_parameters() if torch.isnan(p).any()] == []


def test_three_fp32_steps_with_a_refresh_match_jax():
    """Steps 0 and 1, the refresh, step 2 of the port's step against JAX
    ``make_train_step`` and ``refresh_gram``, from the same state, batch
    and drop-path plans, a loss-weight schedule on top."""
    from dinov3_tpu.train.fused_update import build_fused_update
    from dinov3_tpu.train.gram_refresh import refresh_gram as jax_refresh
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState, make_train_step

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train.gram_refresh import refresh_gram
    from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
    from dinov3_tpu_torch.train.schedules import build_schedules
    from dinov3_tpu_torch.train.train_step import TrainState as TState
    from dinov3_tpu_torch.train.train_step import make_train_step as t_make

    w = gram_world(["gram.loss_weight_schedule={start: 0.5, peak: 2.0, end: 1.0, "
                    "warmup_epochs: 1}"])
    jcfg, tcfg, jmeta, params = w["jcfg"], w["tcfg"], w["jmeta"], w["params"]
    jbatch, tmeta = w["jbatch"], w["tmeta"]
    sched = jsched(jcfg)
    opt = build_optimizer(jcfg, params["student"], sched)
    fused = build_fused_update(jcfg, params["student"], sched, ema=True)
    jstep = jax.jit(make_train_step(jmeta, opt, clip_grad=jcfg.optim.clip_grad,
                                    fused_update=fused))
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        jmeta.init_state(), jnp.zeros((), jnp.int32))
    o = tcfg.optim
    topt = ScheduledAdamW(tmeta.student, build_schedules(tcfg),
                          layerwise_decay=o.layerwise_decay,
                          patch_embed_lr_mult=o.patch_embed_lr_mult,
                          dino_head_wd_multiplier=o.dino_head_wd_multiplier,
                          clip_grad=o.clip_grad)
    tstate = TState(meta=tmeta, opt_state=topt.init_state(tmeta.student))
    tstep = t_make(topt)
    bound = 0.0
    weights = []
    for i in range(3):
        if i == 2:
            jstate, tstate = jax_refresh(jstate), refresh_gram(tstate)
            host = jax.tree.map(np.asarray, jstate.params)
            assert all(np.array_equal(a, b) for a, b in zip(
                jax.tree.leaves(host["gram"]["backbone"]),
                jax.tree.leaves(host["teacher"]["backbone"])))
            teacher = tmeta.teacher["backbone"].state_dict()
            assert all(torch.equal(v, teacher[k])
                       for k, v in tmeta.gram["backbone"].state_dict().items())
        s = sched.at(i)
        jstate, jm = jstep(jstate, jbatch, {"teacher_temp": jnp.float32(s["teacher_temp"]),
                                            "momentum": jnp.float32(s["momentum"])},
                           jax.random.key(5))
        tstate, tm = tstep(tstate, w["batch"], {"teacher_temp": s["teacher_temp"],
                                                "momentum": s["momentum"]},
                           plan=_jax_plan(jmeta, jbatch, i))
        for k in LOSSES + ("gram_loss_weight",):
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        weights.append(tm["gram_loss_weight"])
        bound += (1 - float(s["momentum"])) * 2 * float(s["lr"])
        host = jax.tree.map(np.asarray, jstate.params)
        want = meta_state_dicts_from_jax({"t": host["teacher"]})["t"]
        want.update(gram_state_dict(host["gram"]))
        got = {**tmeta.teacher.state_dict(), **tmeta.gram.state_dict()}
        close = total = 0
        for n, wt in want.items():
            wt = wt.numpy()
            err = np.abs(_np(got[n]) - wt)
            tol = 1e-5 * max(np.abs(wt).max(), 1e-3)
            assert (err <= tol + bound).all(), (i, n, err.max(), tol + bound)
            close += int((err <= tol).sum())
            total += err.size
        assert close >= 0.99 * total, (i, close, total)
    assert len(set(weights)) == 3  # the schedule moved the weight each step


# ---------------- the bridge, checkpoints and gram.ckpt ----------------

def _jax_local_save(directory, w, step: int, teacher_seed: int = 2):
    """A JAX local-npz save of a state with a Gram branch (the JAX
    package's own ``Checkpointer._local_save``); its teacher perturbed by
    ``teacher_seed``. Returns the saved params."""
    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState

    params = dict(w["params"], teacher=_noisy(w["params"]["teacher"], teacher_seed))
    opt = build_optimizer(w["jcfg"], params["student"], jsched(w["jcfg"]))
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        w["jmeta"].init_state(), jnp.asarray(step, jnp.int32))
    ckpt = JaxCheckpointer(str(directory), async_save=False, max_to_keep=5)
    try:
        ckpt._local_save(step, jstate)
    finally:
        ckpt.close()
    return params


@pytest.fixture(scope="module")
def bridge_world():
    return gram_world()


def test_train_state_from_jax_maps_the_gram_branch(bridge_world, tmp_path):
    from dinov3_tpu_torch.checkpoint import restore_jax_local
    from dinov3_tpu_torch.interop.from_jax import train_state_from_jax
    from dinov3_tpu_torch.train import build_train_setup

    w = bridge_world
    params = _jax_local_save(tmp_path, w, 3)
    with np.load(tmp_path / "3" / "state.npz") as z:
        payload = train_state_from_jax({k: z[k] for k in z.files})
    want = gram_state_dict(params["gram"])
    assert payload["gram"].keys() == want.keys()
    assert all(torch.equal(payload["gram"][k], want[k]) for k in want)
    setup = build_train_setup(w["tcfg"], w["batch"], device="cpu", seed=11)
    state = restore_jax_local(str(tmp_path), setup.state)
    assert state.step == 3
    assert all(torch.equal(v, want[k]) for k, v in state.meta.gram.state_dict().items())


def test_gram_ckpt_loads_from_a_port_dir_and_a_jax_local_dir(bridge_world, tmp_path):
    """``load_gram_teacher``: from this package's checkpoints, the latest
    step or ``gram.it_load_ema_teacher``'s; from a JAX local-npz directory;
    a leaf the checkpoint holds at another shape keeps its value; a
    missing step raises."""
    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import build_train_setup
    from dinov3_tpu_torch.train.gram_refresh import load_gram_teacher

    w = bridge_world
    # the source run holds one storage token, the Gram run two: the
    # storage tokens keep their values, every other leaf loads
    src_cfg = cfgs(["student.n_storage_tokens=1"])[1]
    src = build_train_setup(src_cfg, make_synthetic_batch(src_cfg, B, seed=1),
                            device="cpu", seed=5)
    ckpt = Checkpointer(str(tmp_path / "port"))
    teachers = {}
    for step in (1, 2):
        with torch.no_grad():
            for p in src.meta.teacher.parameters():
                p.add_(0.01 * step)
        ckpt.save(step, src.state)
        teachers[step] = {k: v.clone() for k, v in src.meta.teacher["backbone"]
                          .state_dict().items()}
    for pick, step in ((-1, 2), (1, 1), (7, None)):
        cfg = cfgs(GRAM + ["student.n_storage_tokens=2", f"gram.ckpt={tmp_path / 'port'}",
                           f"gram.it_load_ema_teacher={pick}"])[1]
        setup = build_train_setup(cfg, make_synthetic_batch(cfg, B, seed=1),
                                  device="cpu", seed=9)
        if step is None:
            with pytest.raises(FileNotFoundError, match="step 7"):
                load_gram_teacher(cfg, setup.state)
            continue
        init = {k: v.clone() for k, v in setup.meta.gram["backbone"].state_dict().items()}
        load_gram_teacher(cfg, setup.state)
        for k, v in setup.meta.gram["backbone"].state_dict().items():
            want = init[k] if k == "storage_tokens" else teachers[step][k]
            assert torch.equal(v, want), (pick, k)
    # a JAX local-npz directory
    params = _jax_local_save(tmp_path / "jax", w, 4, teacher_seed=8)
    tcfg = cfgs(GRAM + [f"gram.ckpt={tmp_path / 'jax'}"])[1]
    setup = build_train_setup(tcfg, w["batch"], device="cpu", seed=9)
    load_gram_teacher(tcfg, setup.state)
    want = meta_state_dicts_from_jax({"t": params["teacher"]})["t"]
    for k, v in setup.meta.gram.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_cli_resumes_bitwise_across_a_gram_refresh(tmp_path):
    """The trainer with the Gram anchor refreshed after iteration 1 (its
    only refresh): 4 iterations in one process against 2, then a resume
    to 4 in a new process; the losses and the final student, teacher,
    moments and Gram branch equal bit for bit. The step-2 save holds the
    refreshed branch (the teacher's backbone) and the count is rebuilt
    (no second refresh on resume)."""
    gram = GRAM + ["gram.it_first_update=2", "gram.update_frequency=2",
                   "gram.max_updates=1"]
    a = run_cli(tmp_path / "a", "--max-iterations", 4,
                "--record-losses", tmp_path / "a.jsonl", extra=gram)
    assert a["gram"] == "frozen" and a["iterations"] == 4
    r = tmp_path / "r"
    run_cli(r, "--max-iterations", 2, "--record-losses", tmp_path / "r1.jsonl", extra=gram)
    second = run_cli(r, "--max-iterations", 4, "--record-losses", tmp_path / "r2.jsonl",
                     extra=gram)
    assert second["start_iteration"] == 2 and second["iterations"] == 4
    want = read_losses(tmp_path / "a.jsonl")
    got = {**read_losses(tmp_path / "r1.jsonl"), **read_losses(tmp_path / "r2.jsonl")}
    assert sorted(got) == [0, 1, 2, 3] and got == want
    assert all(math.isfinite(row["gram_loss"]) for row in got.values())
    s2 = load_ckpt(r, 2)
    assert all(torch.equal(v, s2["teacher"][k]) for k, v in s2["gram"].items())
    wa, wr = load_ckpt(tmp_path / "a", 4), load_ckpt(r, 4)
    for key in ("student", "teacher", "mu", "nu", "gram"):
        assert wa[key].keys() == wr[key].keys()
        for n in wa[key]:
            assert torch.equal(wa[key][n], wr[key][n]), (key, n)
    # one refresh only: at step 4 the teacher has moved on from the branch
    assert not torch.equal(wa["gram"]["backbone.cls_token"],
                           wa["teacher"]["backbone.cls_token"])
    assert torch.equal(wa["gram"]["backbone.cls_token"], s2["gram"]["backbone.cls_token"])
