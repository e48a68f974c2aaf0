"""The recipe's options in the port against the JAX package, fp32 on the
CPU at ``vit_test`` size (the ``SMOL`` overrides of
``tests/test_torch_train.py``): the streaming and materialized target
engines under both centerings, bf16 targets, activation checkpointing,
the microbatch split and gradient accumulation; and the recipe YAML as
written, stepped at a cut depth.

Weights are JAX's (perturbed so zero-initialised leaves count) bridged by
``interop/from_jax.py``; drop-path plans are JAX's, handed across as
numpy; the incoming centers are seeded nonzero so centering is exercised.

Tolerances:
- loss terms: 1e-5 relative; every student gradient leaf: 1e-4 of that
  leaf's largest magnitude; the new centers: 1e-6 relative (an fp32 mean
  of logits that agree to ~1e-6, and one EMA step);
- remat modes against each other on the CPU: bitwise; against JAX's
  ``remat="blocks"``: the meta-arch tolerances above;
- ``split_microbatches``: bitwise;
- three accumulated steps: loss terms 1e-4 relative and the teacher within
  the bound of ``test_three_fp32_steps_match_jax_make_train_step``; the
  centers 1e-5 relative (they follow teacher logits that move within that
  bound).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import B, LOSSES, SMOL, _jax_plan, _noisy, _np, cfgs

# streaming targets over the 64 prototypes in tiles of choose_k_tile(64, 24) = 16
STREAMING = ["loss.streaming_targets=true", "loss.k_tile=24"]


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    """Single-device comparisons, without another test's mesh (as in
    ``tests/test_torch_train.py``)."""
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


@pytest.fixture(scope="module")
def base():
    """Perturbed JAX weights and one batch; the parameter tree is the same
    under every option tested here."""
    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    prev = get_current_mesh()
    set_current_mesh(None)
    jcfg, _ = cfgs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    batch = make_synthetic_batch(jcfg, B, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jmeta.init_params(jax.random.key(0), jbatch))
    params = {"student": _noisy(params["student"], 1),
              "teacher": _noisy(params["teacher"], 2)}
    set_current_mesh(prev)
    rng = np.random.default_rng(21)
    centers = {k: (rng.standard_normal((1, 64)) * 0.1).astype(np.float32)
               for k in ("dino_center", "ibot_center")}
    return {"batch": batch, "jbatch": jbatch, "params": params, "centers": centers,
            "plan_meta": jmeta}


def metas(base, extra):
    """(JAX meta, port meta) under ``extra`` with the base weights."""
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import SSLMetaArch

    jcfg, tcfg = cfgs(extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    tmeta = SSLMetaArch(tcfg)
    sds = meta_state_dicts_from_jax(base["params"])
    tmeta.student.load_state_dict(sds["student"])
    tmeta.teacher.load_state_dict(sds["teacher"])
    return jmeta, tmeta


def jax_value_and_grad(jmeta, base, plan):
    params = base["params"]
    state = {k: jnp.asarray(v) for k, v in base["centers"].items()}

    def loss(student):
        total, (d, new_state) = jmeta.forward(
            student, {"teacher": params["teacher"]}, base["jbatch"],
            teacher_temp=0.07, state=state, iteration=jnp.asarray(0, jnp.int32),
            rng_plan={"packed": plan})
        return total, (d, new_state)

    (_, (jd, jstate)), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params["student"])
    return jd, jstate, jgrads


def port_value_and_grad(tmeta, base, plan):
    from dinov3_tpu_torch.rng import plan_to_device
    from dinov3_tpu_torch.train import put_batch

    tmeta.student.zero_grad(set_to_none=True)
    state = {k: torch.from_numpy(v) for k, v in base["centers"].items()}
    total, d, new_state = tmeta(put_batch(base["batch"], "cpu"), teacher_temp=0.07,
                                plan=plan_to_device(plan, "cpu"), state=state)
    total.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in tmeta.student.named_parameters()}
    tmeta.student.zero_grad(set_to_none=True)
    return {k: float(v) for k, v in d.items()}, new_state, grads


def assert_meta_matches(jd, jstate, jgrads, d, state, grads):
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax

    for k in LOSSES:
        np.testing.assert_allclose(d[k], float(jd[k]), rtol=1e-5, err_msg=k)
    for k in ("dino_center", "ibot_center"):
        np.testing.assert_allclose(_np(state[k]), np.asarray(jstate[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    want = meta_state_dicts_from_jax({"g": jax.tree.map(np.asarray, jgrads)})["g"]
    for n, g in grads.items():
        w = want[n].numpy()
        np.testing.assert_allclose(_np(g), w, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg=n)


# ---------------- the meta-arch under each target engine ----------------

@pytest.mark.parametrize("centering,streaming,target", [
    ("sinkhorn_knopp", True, "fp32"), ("sinkhorn_knopp", False, "fp32"),
    ("softmax_center", True, "fp32"), ("softmax_center", False, "fp32"),
    ("sinkhorn_knopp", True, "bf16"),
])
def test_meta_losses_centers_and_grads_match_jax(base, centering, streaming, target):
    extra = [f"train.centering={centering}",
             f"loss.streaming_targets={str(streaming).lower()}", "loss.k_tile=24",
             f"compute_precision.target_dtype={target}"]
    jmeta, tmeta = metas(base, extra)
    assert tmeta.streaming_targets == streaming and tmeta.loss_k_tile == 24
    plan = _jax_plan(base["plan_meta"], base["jbatch"], 0)
    jd, jstate, jgrads = jax_value_and_grad(jmeta, base, plan)
    d, state, grads = port_value_and_grad(tmeta, base, plan)
    assert_meta_matches(jd, jstate, jgrads, d, state, grads)
    moved = not np.array_equal(_np(state["dino_center"]), base["centers"]["dino_center"])
    assert moved == (centering == "softmax_center")


def test_remat_modes_are_bitwise_alike_and_match_jax_blocks(base):
    """none / attn / blocks / full: identical losses, centers and gradients
    on the CPU, bit for bit; JAX's ``remat="blocks"``
    (``train.checkpointing=true``) within the meta-arch tolerances."""
    plan = _jax_plan(base["plan_meta"], base["jbatch"], 0)
    runs = {}
    for extra, mode in ((["parallel.remat=none"], "none"), (["parallel.remat=attn"], "attn"),
                        (["train.checkpointing=true"], "blocks"),
                        (["train.checkpointing_full=true"], "full")):
        jmeta, tmeta = metas(base, STREAMING + extra)
        assert tmeta.student["backbone"].remat == mode
        assert tmeta.teacher["backbone"].remat == "none"
        runs[mode] = port_value_and_grad(tmeta, base, plan)
        if mode == "blocks":
            jblocks = jax_value_and_grad(jmeta, base, plan)
    d0, s0, g0 = runs["none"]
    for mode, (d, s, g) in runs.items():
        assert d == d0, mode
        assert all(torch.equal(s[k], s0[k]) for k in s0), mode
        assert all(torch.equal(g[n], g0[n]) for n in g0), (mode, [n for n in g0
                                                                   if not torch.equal(g[n], g0[n])])
    assert_meta_matches(*jblocks, *runs["blocks"])


def test_remat_recomputes_all_but_the_weight_matmuls_under_blocks():
    """The ops one block's backward runs: without remat, none of the
    forward's; under "full", the whole forward again (its four weight
    matmuls qkv, proj, fc1, fc2 among them); under "blocks", the same
    recompute less those four matmuls, whose outputs were saved. The
    gradients are equal in every mode, bit for bit."""
    from dinov3_tpu_torch.ops.block import SelfAttentionBlock, remat_forward

    from test_torch_streaming import _Recorder

    torch.manual_seed(0)
    blk = SelfAttentionBlock(32, 2, layerscale_init=1.0, dtype=torch.float32)
    x0 = torch.randn(3, 10, 32)
    ops, grads = {}, {}
    for mode in ("none", "blocks", "full"):
        x = x0.clone().requires_grad_()
        out = remat_forward(blk, mode)(x)
        with _Recorder() as rec:
            out.sum().backward()
        ops[mode] = [op for op, _, _ in rec.made]
        grads[mode] = [x.grad] + [p.grad.clone() for p in blk.parameters()]
        blk.zero_grad(set_to_none=True)

    def n(mode, name):
        return sum(op == name for op in ops[mode])

    mm = "aten.mm.default"
    assert n("none", mm) == 8            # dX and dW of each weight matmul
    assert n("full", mm) == 8 + 4 and n("blocks", mm) == 8
    assert len(ops["none"]) < len(ops["blocks"]) < len(ops["full"])
    for mode in ("blocks", "full"):
        assert all(torch.equal(a, b) for a, b in zip(grads[mode], grads["none"])), mode


# ---------------- gradient accumulation ----------------

def test_split_microbatches_is_bitwise_the_jax_split(base):
    from dinov3_tpu.train.train_step import split_microbatches as jsplit

    from dinov3_tpu_torch.train.train_step import split_microbatches

    for accum in (1, 2, 4):
        want = jsplit(base["jbatch"], accum)
        got = split_microbatches(base["batch"], accum)
        got_t = split_microbatches({k: torch.from_numpy(v) for k, v in base["batch"].items()},
                                   accum)
        assert len(got) == len(got_t) == accum
        for k in base["batch"]:
            w = np.asarray(want[k])
            stacked = np.stack([mb[k] for mb in got]) if accum > 1 else got[0][k]
            stacked_t = (torch.stack([mb[k] for mb in got_t]).numpy() if accum > 1
                         else got_t[0][k].numpy())
            assert stacked.dtype == w.dtype and stacked.shape == w.shape, k
            np.testing.assert_array_equal(stacked, w, err_msg=k)
            np.testing.assert_array_equal(stacked_t, w, err_msg=k)


def test_accum_steps_that_do_not_divide_the_batch_raise(base):
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.train import build_train_setup
    from dinov3_tpu_torch.train.train_step import split_microbatches

    with pytest.raises(ValueError, match="accum_steps=3"):
        split_microbatches(base["batch"], 3)
    with pytest.warns(UserWarning, match="accum_steps=3 does not divide"):
        cfg = load_config(None, SMOL + [f"train.batch_size_per_device={B}",
                                        "optim.accum_steps=3"])
    with pytest.raises(ValueError, match="accum_steps=3"):
        build_train_setup(cfg, base["batch"], device="cpu")


def test_three_accumulated_steps_match_jax_make_train_step(base):
    """``optim.accum_steps=2`` under softmax centering and streaming
    targets: three steps of the port against JAX ``make_train_step(...,
    accum_steps=2)`` (fused update) from the same state, batch and
    per-microbatch drop-path plans (JAX's ``fold_in(fold_in(key, it),
    j)`` plans, handed across)."""
    from dinov3_tpu.train.fused_update import build_fused_update
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState, make_train_step
    from dinov3_tpu.train.train_step import split_microbatches as jsplit

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
    from dinov3_tpu_torch.train.schedules import build_schedules
    from dinov3_tpu_torch.train.train_step import TrainState as TState
    from dinov3_tpu_torch.train.train_step import make_train_step as t_make

    extra = STREAMING + ["train.centering=softmax_center", "optim.accum_steps=2"]
    jmeta, tmeta = metas(base, extra)
    jcfg, tcfg = cfgs(extra)
    params = base["params"]
    sched = jsched(jcfg)
    opt = build_optimizer(jcfg, params["student"], sched)
    fused = build_fused_update(jcfg, params["student"], sched, ema=True)
    jstep = jax.jit(make_train_step(jmeta, opt, clip_grad=jcfg.optim.clip_grad,
                                    fused_update=fused, accum_steps=2))
    centers = {k: jnp.asarray(v) for k, v in base["centers"].items()}
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        centers, jnp.zeros((), jnp.int32))
    o = tcfg.optim
    topt = ScheduledAdamW(tmeta.student, build_schedules(tcfg),
                          layerwise_decay=o.layerwise_decay,
                          patch_embed_lr_mult=o.patch_embed_lr_mult,
                          dino_head_wd_multiplier=o.dino_head_wd_multiplier,
                          clip_grad=o.clip_grad)
    tstate = TState(meta=tmeta, opt_state=topt.init_state(tmeta.student),
                    center_state={k: torch.from_numpy(v.copy())
                                  for k, v in base["centers"].items()})
    tstep = t_make(topt, accum_steps=2)
    micro = jsplit(base["jbatch"], 2)
    key = jax.random.key(5)
    bound = 0.0
    for i in range(3):
        s = sched.at(i)
        jstate, jm = jstep(jstate, base["jbatch"],
                           {"teacher_temp": jnp.float32(s["teacher_temp"]),
                            "momentum": jnp.float32(s["momentum"])}, key)
        plans = [jax.tree.map(np.asarray, jmeta.build_rng_plan(
            jax.random.fold_in(jax.random.fold_in(key, i), j),
            {k: v[j] for k, v in micro.items()})["packed"]) for j in range(2)]
        tstate, tm = tstep(tstate, base["batch"],
                           {"teacher_temp": s["teacher_temp"], "momentum": s["momentum"]},
                           plan=plans)
        for k in LOSSES:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        for k in ("dino_center", "ibot_center"):
            w = np.asarray(jstate.center_state[k])
            np.testing.assert_allclose(_np(tstate.center_state[k]), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(), err_msg=f"step {i} {k}")
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


def test_accumulated_step_draws_its_plans_per_microbatch():
    """Without plans the step draws one per microbatch, keyed by (seed,
    iteration, j): two setups from one seed take the same step; a single
    plan (not a list) is refused under accumulation."""
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.rng import packed_pass_plan, step_generator
    from dinov3_tpu_torch.train import build_train_setup

    _, tcfg = cfgs(STREAMING + ["optim.accum_steps=2"])
    batch = make_synthetic_batch(tcfg, B, seed=1)
    runs = []
    for _ in range(2):
        setup = build_train_setup(tcfg, batch, device="cpu", seed=3)
        _, m = setup.step_fn(setup.state, batch, setup.scalars(0))
        runs.append(m)
    assert runs[0] == runs[1] and all(np.isfinite(runs[0][k]) for k in LOSSES)
    a = packed_pass_plan(step_generator(3, 0, 0), 2, 7, 0.3)["drop_path"]["idx"]
    b = packed_pass_plan(step_generator(3, 0, 1), 2, 7, 0.3)["drop_path"]["idx"]
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="one plan per microbatch"):
        setup.step_fn(setup.state, batch, setup.scalars(1), plan={"drop_path": {}})


# ---------------- the recipe as written ----------------

def test_the_recipe_yaml_builds_and_steps_at_cut_depth():
    """``configs/train/vitl16_im1k.yaml`` with only ``data.backend=synthetic``
    (B=64, streaming Sinkhorn targets, K-tile 8192 over 65,536 prototypes,
    ViT-L width): set up with one block on the CPU and stepped once on a
    2-image batch (the lr scaling still reads the recipe's B=64)."""
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    cfg = load_config("configs/train/vitl16_im1k.yaml", ["data.backend=synthetic"])
    assert cfg.train.batch_size_per_device == 64
    batch = make_synthetic_batch(cfg, 2, seed=0)
    setup = build_train_setup(cfg, batch, device="cpu", seed=0, n_blocks=1)
    meta = setup.meta
    assert meta.streaming_targets and meta.loss_k_tile == 8192
    assert meta.centering == "sinkhorn_knopp" and meta.student["backbone"].embed_dim == 1024
    state, m = setup.step_fn(setup.state, batch, setup.scalars(0))
    assert state.step == 1 and all(np.isfinite(m[k]) for k in LOSSES)
    assert all(np.isfinite(v) for k, v in m.items() if k.startswith("grad_norm/"))
