"""The fp8 / int8 training arms of the port (``dinov3_tpu_torch/ops/lowp.py``,
``ops/common.py fp8_matmul``, their wiring through the step, the
checkpoints and the JAX bridge) against the JAX package, on the CPU, at
``vit_test`` size (``tests/test_torch_train.py``'s ``SMOL``: fp32
compute, so the weights' "bf16 view" is fp32 on both sides).

Tolerances:
- scales, quantizer codes, amax rings (init, step, bridge, checkpoint
  round trip) and scale sites: bitwise;
- ``lowp_matmul`` on the same inputs: int8 output bitwise (both sum the
  code products exactly: JAX in int32, the port in float64); fp8 output
  within one bf16 rounding (2^-8 of the output's largest magnitude: both
  sum the same fp32 products of codes in other orders, then round to
  bf16); dx and dw within 2^-7 of their largest magnitude (bf16 products
  of the dequantized codes, summed in other orders);
- the legacy ``fp8_matmul``: forward as ``lowp_matmul`` fp8; its
  gradients are cast to float8_e4m3 unscaled, so an element may land one
  fp8 step apart where the fp32 sums differ in their last bits: within
  one fp8 quantum (2^-3 relative, the e4m3 spacing) of each element;
- the student's gradients at an arm (JAX ``value_and_grad`` of the meta
  forward with the same scales): a code can flip where JAX's and the
  port's fp32 activations differ in their last bits (other summation
  orders), and one flip moves a product, and the gradient entries that
  flow through it, by one quantum: at most 2^-3 of the leaf's scale for
  fp8 (the e4m3 spacing relative to the code) and 1/qmax = 1/127 for
  int8. So every entry lies within that quantum plus 1e-4 of the leaf's
  scale (the fp32 bound of
  ``test_meta_forward_and_every_student_grad_match_jax``), and at least
  99 % of each leaf's entries within the 1e-4 alone, which a zero,
  sign-flipped or wide-activation backward does not meet;
- one training step per arm (iteration 0, at the warm-up's lr of 0, and
  iteration 1, the first that moves the student): loss terms within 1e-3 relative (a step's
  flips move them by far less); the updated student, teacher and rings
  within the fp32 step's bound (``test_three_fp32_steps_match_jax_make_train_step``:
  Adam's first step moves an entry by up to lr either way, the EMA moves
  the teacher by (1 - m) of that) plus 1e-5 of each leaf's scale, and at
  least 99 % of each tree's entries within the 1e-5 alone (Adam's first
  step is lr * sign(g), so a gradient of the wrong sign moves its entry
  by 2 lr);
- the drift probe on JAX's own probe batch: 2e-2 relative (the bf16
  reference product on either side rounds in its own order);
"""

import contextlib
import copy
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import SMOL, _jax_plan, _noisy, _np, cfgs

B = 4
ARMS = ("fp8", "int8")


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes (fp8 has no numpy dtype)."""
    return t.contiguous().view(torch.uint8).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint8)


# ---------------- the scale math and the quantizer ----------------

@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantizer_codes_and_scales_are_bitwise_jax(arm, dtype):
    from dinov3_tpu.ops.lowp import current_scale as j_cur
    from dinov3_tpu.ops.lowp import qspec as j_qspec
    from dinov3_tpu.ops.lowp import scale_from_history as j_hist
    from dinov3_tpu.ops.lowp import symmetric_quantize as j_quant

    from dinov3_tpu_torch.ops.lowp import current_scale, qspec, quantize, scale_from_history

    rng = np.random.default_rng(0)
    w = (rng.standard_normal((37, 24)) * 0.05).astype(np.float32)
    w[0, :4] = [0.5, -0.5, 1.5, -2.5]  # ties at some scale
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jw, tw = jnp.asarray(w).astype(jdt), torch.from_numpy(w).to(tdt)
    js, ts = j_qspec(arm), qspec(arm)
    assert (ts.qmax, str(ts.qdtype).split(".")[-1]) == (js.qmax, jnp.dtype(js.qdtype).name)
    s_x = current_scale(tw, ts.qmax)
    np.testing.assert_array_equal(s_x.numpy(), np.asarray(j_cur(jw, js.qmax)))
    for scale in (s_x, torch.tensor(0.01), torch.tensor(1.0 / 3)):
        want = j_quant(jw, jnp.asarray(scale.numpy()), js.qmax, js.qdtype)
        got = quantize(tw, scale, ts)
        np.testing.assert_array_equal(_bits(got), _jbits(want))
    hist = np.abs(rng.standard_normal((5, 16))).astype(np.float32)
    hist[2] = 0.0  # a dead kernel scales by 1
    for margin in (1.0, 1.25):
        np.testing.assert_array_equal(
            scale_from_history(torch.from_numpy(hist), ts.qmax, margin).numpy(),
            np.asarray(j_hist(jnp.asarray(hist), js.qmax, margin)))
    # the zero tensor: finite scale, zero codes
    z = torch.zeros(3, 4)
    assert float(current_scale(z, ts.qmax)) == float(j_cur(jnp.zeros((3, 4)), js.qmax))


def test_castable_weights_and_scale_sites_are_jax_s():
    """The same weights are quantized, and each scale is read where JAX
    reads it (``lowp_scale_site``: ``fc1_kernel`` on the mlp module)."""
    from dinov3_tpu.ops.lowp import lowp_kernel_path as j_path
    from dinov3_tpu.ops.lowp import lowp_scale_site as j_site
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.ops.lowp import lowp_kernel_path, lowp_scale_site
    from dinov3_tpu_torch.train import SSLMetaArch

    for extra in ([], ["student.ffn_layer=swiglu"]):
        jcfg, tcfg = cfgs(extra)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jm = JMeta(jcfg)
        from dinov3_tpu.data import make_synthetic_batch

        jb = {k: jnp.asarray(v) for k, v in make_synthetic_batch(jcfg, B, seed=0).items()}
        params = jm.init_params(jax.random.key(0), jb)
        import flax.linen as nn

        bb = nn.meta.unbox(params["student"]["backbone"])
        jsites = set()
        for path, _ in jax.tree_util.tree_flatten_with_path(bb)[0]:
            if j_path(path):
                parent, name = j_site(path)
                jsites.add((parent, name))
        tm = SSLMetaArch(tcfg)
        tsites = set()
        for n, _ in tm.student["backbone"].named_parameters():
            if lowp_kernel_path(n):
                parent, child = lowp_scale_site(n)
                b, i, mod = parent.split(".")
                tsites.add(((f"{b}_{i}", mod), f"{child}_kernel"))
        assert tsites == jsites and len(tsites) == 4 * tm.student["backbone"].n_blocks


# ---------------- the products ----------------

def _jax_lowp(arm, x, w_kn, scale):
    from dinov3_tpu.ops.lowp import lowp_matmul as j_mm

    def f(x, w):
        return j_mm(arm, x, w, scale)

    out, vjp = jax.vjp(f, x, w_kn)
    return out, vjp


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("shape", [(2, 13, 32, 128), (2, 13, 32, 2 * 88)],
                         ids=["mlp_fc1", "swiglu_w12"])
def test_lowp_matmul_and_its_gradients_match_jax(arm, shape):
    from dinov3_tpu_torch.ops.lowp import lowp_matmul

    b, n, k, m = shape
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, n, k)).astype(np.float32)
    w = (rng.standard_normal((m, k)) * 0.05).astype(np.float32)  # [N, K], Linear layout
    g = rng.standard_normal((b, n, m)).astype(np.float32)
    scale = np.float32(np.abs(w).max() * 1.1 / (448.0 if arm == "fp8" else 127.0))
    jx, jw, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w.T, g))
    out, vjp = _jax_lowp(arm, jx, jw, jnp.float32(scale))
    jdx, jdw = vjp(jg)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    got = lowp_matmul(arm, tx, tw, torch.tensor(scale))
    got.backward(torch.from_numpy(g).bfloat16())
    want = np.asarray(out.astype(jnp.float32))
    if arm == "int8":
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, atol=2 ** -8 * np.abs(want).max())
    for t, j in ((tx.grad, np.asarray(jdx.astype(jnp.float32))),
                 (tw.grad, np.asarray(jdw.astype(jnp.float32)).T)):
        np.testing.assert_allclose(_np(t), j, atol=2 ** -7 * np.abs(j).max())


def test_lowp_matmul_saves_codes_not_the_activation():
    from dinov3_tpu_torch.ops.lowp import lowp_matmul

    x = torch.randn(4, 32, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(16, 32, dtype=torch.bfloat16, requires_grad=True)
    y = lowp_matmul("int8", x, w, torch.tensor(0.01))
    saved = {t.dtype for t in y.grad_fn.saved_tensors}
    assert saved == {torch.int8, torch.float32}


def test_legacy_fp8_matmul_matches_jax_forward_and_grads():
    from dinov3_tpu.ops.common import fp8_matmul as j_fp8

    from dinov3_tpu_torch.ops.common import fp8_matmul

    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    w = (rng.standard_normal((48, 32)) * 0.05).astype(np.float32)
    g = (rng.standard_normal((3, 7, 48)) * 4).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w.T).astype(jnp.bfloat16)
    out, vjp = jax.vjp(j_fp8, jx, jw)
    jdx, jdw = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).bfloat16().requires_grad_()
    got = fp8_matmul(tx, tw)
    got.backward(torch.from_numpy(g).bfloat16())
    want = np.asarray(out.astype(jnp.float32))
    np.testing.assert_allclose(_np(got), want, atol=2 ** -8 * np.abs(want).max())
    for t, j in ((tx.grad, np.asarray(jdx.astype(jnp.float32))),
                 (tw.grad, np.asarray(jdw.astype(jnp.float32)).T)):
        assert np.abs(j).max() > 0
        np.testing.assert_allclose(_np(t), j, rtol=2 ** -3, atol=1e-12)


# ---------------- the rings ----------------

@pytest.fixture(scope="module")
def world():
    """JAX's meta-arch and weights (perturbed) with a port meta-arch
    holding the same weights, and one batch."""
    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import SSLMetaArch

    prev = get_current_mesh()
    set_current_mesh(None)
    out = {}
    for arm in ARMS:
        jcfg, tcfg = cfgs([f"train.low_precision.arm={arm}"])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jmeta = JMeta(jcfg)
        batch = make_synthetic_batch(jcfg, B, seed=0)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        params = jax.tree.map(np.asarray, jmeta.init_params(jax.random.key(0), jbatch))
        params = {"student": _noisy(params["student"], 1),
                  "teacher": _noisy(params["teacher"], 2)}
        tmeta = SSLMetaArch(tcfg)
        sds = meta_state_dicts_from_jax(params)
        tmeta.student.load_state_dict(sds["student"])
        tmeta.teacher.load_state_dict(sds["teacher"])
        out[arm] = {"jcfg": jcfg, "tcfg": tcfg, "jmeta": jmeta, "tmeta": tmeta,
                    "batch": batch, "jbatch": jbatch, "params": params}
    set_current_mesh(prev)
    return out


def _port_rings(jrings) -> dict:
    from dinov3_tpu_torch.interop.from_jax import lowp_rings_from_jax

    return lowp_rings_from_jax(jax.tree.map(np.asarray, jrings))


def test_history_init_step_and_scales_are_bitwise_jax(world):
    from dinov3_tpu.ops.lowp import lowp_history_init as j_init
    from dinov3_tpu.ops.lowp import lowp_history_step as j_step
    from dinov3_tpu.ops.lowp import lowp_scales as j_scales

    from dinov3_tpu_torch.ops.lowp import lowp_history_init, lowp_history_step, lowp_scales

    w = world["int8"]
    jbb = jax.tree.map(jnp.asarray, w["params"]["student"]["backbone"])
    bb = copy.deepcopy(w["tmeta"].student["backbone"])
    H = 5
    jh, th = j_init(jbb, H), lowp_history_init(bb, H)
    want = _port_rings(jh)
    assert set(th) == set(want)
    for n in want:
        np.testing.assert_array_equal(th[n].numpy(), want[n].numpy(), err_msg=n)
    # two ring steps from moved masters: JAX's and the port's agree bitwise
    rng = np.random.default_rng(3)
    for step in range(2):
        noise = _noisy(jax.tree.map(np.zeros_like, w["params"]["student"]["backbone"]),
                       10 + step, scale=0.01)
        jbb = jax.tree.map(lambda a, d: a + d, jbb, jax.tree.map(jnp.asarray, noise))
        from dinov3_tpu_torch.interop import state_dict_from_jax

        bb.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jbb)))
        jh, th = j_step(jh, jbb), lowp_history_step(th, bb)
        want = _port_rings(jh)
        for n in want:
            np.testing.assert_array_equal(th[n].numpy(), want[n].numpy(), err_msg=n)
    del rng
    for arm in ARMS:
        ws = jax.tree.map(np.asarray, j_scales(jh, arm, 1.25))
        flat = {}
        for path, v in jax.tree_util.tree_flatten_with_path(ws)[0]:
            keys = [str(getattr(p, "key", p)) for p in path]
            i = keys[0].split("_")[1]
            flat[f"blocks.{i}.{keys[1]}.{keys[2][:-len('_kernel')]}.weight"] = v
        ts = lowp_scales(th, arm, 1.25)
        for n, v in flat.items():
            np.testing.assert_array_equal(ts[n].numpy(), v, err_msg=n)


def test_drift_probe_matches_jax_on_its_probe_batch(world):
    from dinov3_tpu.ops.lowp import lowp_drift_probe as j_probe
    from dinov3_tpu.ops.lowp import lowp_history_init as j_init

    from dinov3_tpu_torch.ops.lowp import lowp_drift_probe

    for arm in ARMS:
        w = world[arm]
        jbb = jax.tree.map(jnp.asarray, w["params"]["student"]["backbone"])
        jh = j_init(jbb, 4)
        want = j_probe(jbb, jh, arm, 1.0, seed=0)

        def probe(k):  # JAX's probe batch for a kernel with k inputs
            x = jax.random.normal(jax.random.key(0), (8, k), jnp.bfloat16)
            return torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()

        got = lowp_drift_probe(w["tmeta"].student["backbone"], _port_rings(jh), arm, 1.0,
                               probe=probe)
        for site, v in want.items():
            if site == "max":
                continue
            parts = site.split("/")  # blocks_0/attn/qkv_kernel
            key = f"blocks.0.{parts[1]}/{parts[2][:-len('_kernel')]}"
            np.testing.assert_allclose(got[key], v, rtol=2e-2, err_msg=key)
        np.testing.assert_allclose(got["max"], want["max"], rtol=2e-2)
        assert 0 < got["max"] < 0.2


def test_warn_lowp_divergence_fires_and_stays_silent():
    from dinov3_tpu.configs.config import warn_lowp_divergence as j_warn

    from dinov3_tpu_torch.configs.config import warn_lowp_divergence

    for fn in (warn_lowp_divergence, j_warn):
        with pytest.warns(UserWarning, match="lowp divergence axis"):
            assert fn(0.5, tol=0.2) is not None
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert fn(0.1, tol=0.2) is None


@pytest.mark.parametrize("extra,match", [
    (["train.low_precision.arm=fp8", "student.fp8_enabled=true"], "fp8_enabled"),
    (["train.low_precision.arm=int8", "student.ffn_layer=moe"], "moe"),
    (["train.low_precision.arm=fp16"], "expected one of"),
])
def test_arm_conflicts_raise(extra, match):
    from dinov3_tpu_torch.train import SSLMetaArch

    _, tcfg = cfgs(extra)
    with pytest.raises(ValueError, match=match):
        SSLMetaArch(tcfg)


# ---------------- one training step per arm ----------------

def _jax_step(w, arm, n_steps=1):
    from dinov3_tpu.configs.config import lowp_cfg
    from dinov3_tpu.ops.lowp import lowp_history_init
    from dinov3_tpu.train.fused_update import build_fused_update
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState, make_train_step

    jcfg, params = w["jcfg"], w["params"]
    lp = lowp_cfg(jcfg)
    sched = jsched(jcfg)
    opt = build_optimizer(jcfg, params["student"], sched)
    fused = build_fused_update(jcfg, params["student"], sched, ema=True)
    jstep = jax.jit(make_train_step(w["jmeta"], opt, clip_grad=jcfg.optim.clip_grad,
                                    fused_update=fused, lowp=lp))
    jp = jax.tree.map(jnp.asarray, params)
    rings = {k: lowp_history_init(jp[k]["backbone"], lp["amax_history_len"])
             for k in ("student", "teacher")}
    jstate = TrainState(jp, opt.init(params["student"]), w["jmeta"].init_state(),
                        jnp.zeros((), jnp.int32), lowp=rings)
    out = []
    for i in range(n_steps):
        s = sched.at(i)
        jstate, jm = jstep(jstate, w["jbatch"],
                           {"teacher_temp": jnp.float32(s["teacher_temp"]),
                            "momentum": jnp.float32(s["momentum"])}, jax.random.key(5))
        out.append((jstate, jm, s))
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_student_gradients_per_arm_match_jax(world, arm):
    """Every student gradient of the meta forward at an arm, through the
    quantized products and their straight-through backward, against
    JAX's ``value_and_grad`` at the same scales (bound: module docstring)."""
    from dinov3_tpu.configs.config import lowp_cfg as j_lowp_cfg
    from dinov3_tpu.ops.lowp import lowp_history_init as j_init
    from dinov3_tpu.ops.lowp import lowp_scales as j_scales

    from dinov3_tpu_torch.configs.config import lowp_cfg
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.ops.lowp import lowp_bound, lowp_history_init, lowp_scales, qspec
    from dinov3_tpu_torch.rng import plan_to_device
    from dinov3_tpu_torch.train import put_batch

    w = world[arm]
    jmeta, jbatch = w["jmeta"], w["jbatch"]
    tmeta = copy.deepcopy(w["tmeta"])
    plan = _jax_plan(jmeta, jbatch, 0)
    jp = jax.tree.map(jnp.asarray, w["params"])
    jl, lp = j_lowp_cfg(w["jcfg"]), lowp_cfg(w["tcfg"])
    jsc = {k: j_scales(j_init(jp[k]["backbone"], jl["amax_history_len"]), arm,
                       jl["scale_margin"]) for k in ("student", "teacher")}

    def loss(student):
        total, (d, _) = jmeta.forward(
            student, {"teacher": jp["teacher"]}, jbatch, teacher_temp=0.07,
            state=jmeta.init_state(), iteration=jnp.asarray(0, jnp.int32),
            rng_plan={"packed": plan}, lowp=jsc)
        return total, d

    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp["student"])
    with contextlib.ExitStack() as bound:
        for k in ("student", "teacher"):
            bb = getattr(tmeta, k)["backbone"]
            sc = lowp_scales(lowp_history_init(bb, lp["amax_history_len"]), arm,
                             lp["scale_margin"])
            bound.enter_context(lowp_bound(bb, sc, arm))
        total, _, _ = tmeta(put_batch(w["batch"], "cpu"), teacher_temp=0.07,
                            plan=plan_to_device(plan, "cpu"))
        total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-3)
    quantum = 2.0 ** -3 if arm == "fp8" else 1.0 / qspec(arm).qmax
    want = meta_state_dicts_from_jax({"g": jax.tree.map(np.asarray, jgrads)})["g"]
    for n, p in tmeta.student.named_parameters():
        wv = want[n].numpy()
        assert p.grad is not None, n
        scale = max(np.abs(wv).max(), 1e-6)
        err = np.abs(_np(p.grad) - wv)
        assert err.max() <= (1e-4 + quantum) * scale, (n, err.max() / scale)
        assert (err <= 1e-4 * scale).mean() >= 0.99, (n, (err <= 1e-4 * scale).mean())


@pytest.mark.parametrize("arm", ARMS)
def test_one_training_step_per_arm_matches_jax(world, arm):
    """JAX's step and the port's at an arm, from the same weights and
    rings: iteration 0 (the warm-up's lr of 0: the losses, the EMA and
    the ring step) and iteration 1, the first whose AdamW moves the
    student (bounds: module docstring)."""
    from dinov3_tpu_torch.configs.config import lowp_cfg
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.ops.lowp import lowp_history_init
    from dinov3_tpu_torch.train.optimizer import ScheduledAdamW
    from dinov3_tpu_torch.train.schedules import build_schedules
    from dinov3_tpu_torch.train.train_step import TrainState, make_train_step

    w = world[arm]
    jsteps = _jax_step(w, arm, n_steps=2)
    tcfg = w["tcfg"]
    tmeta = copy.deepcopy(w["tmeta"])
    o = tcfg.optim
    topt = ScheduledAdamW(tmeta.student, build_schedules(tcfg),
                          layerwise_decay=o.layerwise_decay,
                          patch_embed_lr_mult=o.patch_embed_lr_mult,
                          dino_head_wd_multiplier=o.dino_head_wd_multiplier,
                          clip_grad=o.clip_grad)
    lp = lowp_cfg(tcfg)
    assert lp["arm"] == arm
    rings = {k: lowp_history_init(getattr(tmeta, k)["backbone"], lp["amax_history_len"])
             for k in ("student", "teacher")}
    tstate = TrainState(meta=tmeta, opt_state=topt.init_state(tmeta.student), lowp=rings)
    tstep = make_train_step(topt, lowp=lp)
    moved = {"student": 0.0, "teacher": 0.0}
    for i, (jstate, jm, s) in enumerate(jsteps):
        before = {k: {n: r.clone() for n, r in tstate.lowp[k].items()} for k in tstate.lowp}
        tstate, tm = tstep(
            tstate, w["batch"], {"teacher_temp": s["teacher_temp"], "momentum": s["momentum"]},
            plan=_jax_plan(w["jmeta"], w["jbatch"], i))
        for k in tmeta.loss_names():
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-3, err_msg=f"step {i} {k}")
        lr = float(s["lr"])
        moved["student"] += 2 * lr
        moved["teacher"] += (1 - float(s["momentum"])) * 2 * lr
        assert (lr > 0) == (i > 0), lr
        for k in ("student", "teacher"):
            want = meta_state_dicts_from_jax(
                {"p": jax.tree.map(np.asarray, jstate.params[k])})["p"]
            got = getattr(tmeta, k).state_dict()
            close = total = 0
            for n, wv in want.items():
                wv = wv.numpy()
                err = np.abs(_np(got[n]) - wv)
                tol = 1e-5 * max(np.abs(wv).max(), 1e-3)
                assert err.max() <= tol + moved[k], (i, k, n, err.max(), tol + moved[k])
                close += int((err <= tol).sum())
                total += err.size
            assert close >= 0.99 * total, (i, k, close, total)
            close = total = 0
            for n, r in _port_rings(jstate.lowp[k]).items():
                r, t = r.numpy(), tstate.lowp[k][n].numpy()
                err = np.abs(t - r)
                tol = 1e-5 * float(r.max())
                assert err.max() <= tol + moved[k], (i, k, n, err.max(), tol + moved[k])
                close += int((err <= tol).sum())
                total += err.size
                # the newest slot moved, the oldest left
                np.testing.assert_array_equal(t[:-1], before[k][n][1:].numpy())
            assert close >= 0.99 * total, (i, k, close, total)


def test_bf16_arm_keeps_no_rings_and_the_unchanged_step(world):
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    _, tcfg = cfgs(["train.low_precision.amax_history_len=7"])
    batch = make_synthetic_batch(tcfg, B, seed=0)
    a = build_train_setup(tcfg, batch, device="cpu", seed=3)
    _, plain = cfgs()
    b = build_train_setup(plain, batch, device="cpu", seed=3)
    assert a.state.lowp is None and a.lowp_drift is None
    _, ma = a.step_fn(a.state, batch, a.scalars(0))
    _, mb = b.step_fn(b.state, batch, b.scalars(0))
    assert ma == mb


# ---------------- checkpoints and the bridge ----------------

def _setup(arm, seed=3):
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    _, tcfg = cfgs([] if arm == "bf16" else [f"train.low_precision.arm={arm}"])
    batch = make_synthetic_batch(tcfg, B, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_train_setup(tcfg, batch, device="cpu", seed=seed), batch


def test_checkpoint_round_trip_and_cross_arm_restore(tmp_path):
    """fp8 -> fp8 restores the rings bitwise (and a resumed step equals
    the uninterrupted one); bf16 -> fp8 reseeds them from the restored
    masters; fp8 -> bf16 ignores them (JAX's ``test_cross_arm_checkpoint``)."""
    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.ops.lowp import lowp_history_init

    q, batch = _setup("fp8")
    state, _ = q.step_fn(q.state, batch, q.scalars(0))
    ck = Checkpointer(str(tmp_path / "q"))
    ck.save(1, state)
    saved = {n: t.clone() for n, t in state.meta.student.state_dict().items()}
    _, want = q.step_fn(state, batch, q.scalars(1))
    q2, _ = _setup("fp8")  # the same seed: the same drop-path plans
    restored = ck.restore(q2.state)
    for k in ("student", "teacher"):
        for n, t in restored.lowp[k].items():
            np.testing.assert_array_equal(t.numpy(), _ring_at(ck, k, n))
    _, got = q2.step_fn(restored, batch, q2.scalars(1))
    assert got == want

    b, _ = _setup("bf16")
    bstate, _ = b.step_fn(b.state, batch, b.scalars(0))
    ckb = Checkpointer(str(tmp_path / "b"))
    ckb.save(1, bstate)
    q3, _ = _setup("fp8", seed=11)
    r = ckb.restore(q3.state)
    H = q3.lowp["amax_history_len"]
    for k in ("student", "teacher"):
        fresh = lowp_history_init(getattr(r.meta, k)["backbone"], H)
        for n, t in r.lowp[k].items():
            np.testing.assert_array_equal(t.numpy(), fresh[n].numpy())
    assert all(torch.equal(x, y) for x, y in zip(r.meta.student.state_dict().values(),
                                                 b.meta.student.state_dict().values()))

    b2, _ = _setup("bf16", seed=13)
    back = Checkpointer(str(tmp_path / "q")).restore(b2.state)
    assert back.lowp is None
    assert all(torch.equal(t, saved[n]) for n, t in back.meta.student.state_dict().items())


def _ring_at(ck, k, n):
    payload = torch.load(os.path.join(ck.directory, str(ck.latest_step()), "state.pt"),
                         weights_only=True)
    return payload["lowp"][k][n].numpy()


@pytest.mark.parametrize("scanned", [False, True], ids=["unscanned", "scanned"])
def test_jax_state_with_lowp_rings_bridges_bitwise(world, scanned):
    """A JAX ``TrainState`` with amax rings, as its local-npz checkpoint
    keys it, loads into the port's state: rings bitwise, in the unscanned
    (``blocks_N``) and the scanned (``blocks/block``, [L, H]) trees."""
    from dinov3_tpu.ops.lowp import lowp_history_init as j_init

    from dinov3_tpu_torch.checkpoint import load_payload
    from dinov3_tpu_torch.interop.from_jax import train_state_from_jax

    w = world["fp8"]
    jp = w["params"]
    H = 16  # the configured length: rings of another length would be reseeded
    # rings a fresh init would not give (every slot its own value)
    rings = {k: jax.tree.map(lambda a: np.asarray(a) * np.linspace(0.5, 1.5, H, dtype=np.float32),
                             j_init(jax.tree.map(jnp.asarray, jp[k]["backbone"]), H))
             for k in ("student", "teacher")}
    if scanned:  # the scanned layout of the same rings: [L, H] at blocks/block
        def stack(tree):
            n = len([k for k in tree if k.startswith("blocks_")])
            return {"blocks": {"block": jax.tree.map(
                lambda *a: np.stack(a), *[tree[f"blocks_{i}"] for i in range(n)])}}
        jrings = {k: stack(v) for k, v in rings.items()}
    else:
        jrings = rings
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched

    opt = build_optimizer(w["jcfg"], jp["student"], jsched(w["jcfg"]))
    from dinov3_tpu.train.train_step import TrainState as JState

    js = JState(jp, opt.init(jp["student"]), w["jmeta"].init_state(),
                jnp.asarray(0, jnp.int32), lowp=jrings)
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(js)[0]}
    payload = train_state_from_jax(flat)
    q, _ = _setup("fp8")
    load_payload(q.state, payload)
    want = {k: _port_rings(rings[k]) for k in rings}
    for k in ("student", "teacher"):
        assert set(q.state.lowp[k]) == set(want[k])
        for n, t in q.state.lowp[k].items():
            np.testing.assert_array_equal(t.numpy(), want[k][n].numpy(), err_msg=f"{k} {n}")
