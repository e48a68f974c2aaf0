"""The port's serve path against the JAX serve path, on the CPU at
``vit_test`` size: the host batcher's planes (bitwise), the packed
forward, the serving cast, and the whole engine on the same seeded
requests and bridged weights. The JAX engine is built with
``kernels.flash_attention=pallas``, so its forward runs the Pallas flash
kernel (K1) in interpret mode; the port runs K1's plain version.

Tolerances:
- fp32 features: 1e-4 (whole-model fp32, sums in other orders);
- bf16 serving weights and compute: 2^-5 of the largest feature
  magnitude, i.e. about 8 bf16 ulps there. Both sides round every
  matmul, norm and residual add to bf16 (8 significant bits); a one-ulp
  difference early in the stack (the port scales attention logits after
  the product, its softmax and GELU run in fp32 inside torch) carries
  through the blocks and the final norm.
"""

import dataclasses
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinov3_tpu_torch.interop import state_dict_from_jax

SERVE_SMOL = [
    "student.arch=vit_test", "student.patch_size=4",
    "kernels.flash_attention=pallas",
    "serve.min_px=8", "serve.max_px=24", "serve.rows=3",
    "serve.row_tokens=40", "serve.max_segments_per_row=6",
]
SIZES = [(8, 8), (16, 16), (12, 8), (24, 16), (8, 12), (16, 24), (20, 20),
         (8, 20)]


def _images(seed=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, w, 3)).astype(np.float32) for h, w in SIZES]


def _cfgs(extra=()):
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default

    cfg, tcfg = get_default_config(), t_default()
    apply_dot_overrides(cfg, SERVE_SMOL + list(extra))
    t_apply(tcfg, SERVE_SMOL + list(extra))
    return cfg, tcfg


def _jax_params(model, seed=0):
    """Init + a perturbation so zero-initialised leaves count."""
    params = nn.meta.unbox(model.init(jax.random.key(seed),
                                      jnp.zeros((1, 16, 16, 3))))["params"]
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed + 1)
    return jax.tree.unflatten(tree, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        for a in leaves])


def _drain(engine, images):
    for i, im in enumerate(images):
        engine.submit(im, request_id=i)
    out = []
    while engine.queue_len:
        out.extend(engine.flush())
    return {r.request_id: r for r in out}


# ---------------- host batcher ----------------

def test_batcher_planes_bitwise_equal_to_jax():
    from dinov3_tpu.serve import ContinuousBatcher as JBatcher
    from dinov3_tpu.serve import ServeRequest as JRequest
    from dinov3_tpu.serve import serve_layout_from_cfg as j_layout

    from dinov3_tpu_torch.serve import ContinuousBatcher, ServeRequest
    from dinov3_tpu_torch.serve import serve_layout_from_cfg

    cfg, tcfg = _cfgs(["student.n_storage_tokens=2"])
    layout = serve_layout_from_cfg(tcfg)
    assert dataclasses.asdict(layout) == dataclasses.asdict(j_layout(cfg))
    jb, tb = JBatcher(j_layout(cfg)), ContinuousBatcher(layout)
    for i, im in enumerate(_images() * 2):
        jb.admit(JRequest(request_id=i, image=im, arrival_s=0.001 * i))
        tb.admit(ServeRequest(request_id=i, image=im, arrival_s=0.001 * i))
    packs = 0
    while jb.queue_len:
        jp, tp = jb.next_pack(), tb.next_pack()
        assert [(p.request.request_id, p.row, p.slot, p.offset)
                for p in jp.placements] == \
            [(p.request.request_id, p.row, p.slot, p.offset)
             for p in tp.placements]
        for key, plane in jp.planes.items():
            assert tp.planes[key].dtype == plane.dtype, key
            assert np.array_equal(tp.planes[key], plane), key
        packs += 1
    assert packs >= 2 and tb.queue_len == 0


# ---------------- packed forward and engine ----------------

def test_packed_feature_forward_matches_jax():
    from dinov3_tpu.models import build_backbone as jax_build
    from dinov3_tpu.serve import ContinuousBatcher as JBatcher
    from dinov3_tpu.serve import ServeRequest as JRequest
    from dinov3_tpu.serve import serve_layout_from_cfg as j_layout

    from dinov3_tpu_torch.models import build_backbone

    extra = ["compute_precision.compute_dtype=fp32",
             "student.n_storage_tokens=2",
             "student.untie_cls_and_patch_norms=true"]
    cfg, tcfg = _cfgs(extra)
    jm = jax_build(cfg, teacher=True)
    params = _jax_params(jm)
    tm = build_backbone(tcfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params))
    batcher = JBatcher(j_layout(cfg))
    for i, im in enumerate(_images()):
        batcher.admit(JRequest(request_id=i, image=im))
    planes = batcher.next_pack().planes
    args = [planes[k] for k in ("patches", "coords", "prefix_idx", "seg")]
    want = jm.apply({"params": params}, *map(jnp.asarray, args),
                    method="packed_feature_forward")
    got = tm.packed_feature_forward(*map(torch.from_numpy, args))
    for key in ("cls_rows", "patch_rows"):
        got_k = got[key].detach().numpy()
        assert np.isfinite(got_k).all()  # all-pad rows stay finite
        np.testing.assert_allclose(got_k, np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_engine_matches_jax_engine(dtype):
    from dinov3_tpu.models import build_backbone as jax_build
    from dinov3_tpu.serve import PackedServeEngine as JEngine
    from dinov3_tpu.serve import cast_serving_tree as jax_cast
    from dinov3_tpu.serve import serve_layout_from_cfg as j_layout

    from dinov3_tpu_torch.models import build_backbone
    from dinov3_tpu_torch.serve import (
        PackedServeEngine,
        build_serve_engine,
        serve_layout_from_cfg,
    )

    extra = [f"compute_precision.compute_dtype={dtype}",
             "serve.patch_features=true"]
    cfg, tcfg = _cfgs(extra)
    jm = jax_build(cfg, teacher=True)
    params = _jax_params(jm)
    if dtype == "bf16":  # the serving tree, through each side's own cast
        params = jax_cast(params)
        eng = build_serve_engine(tcfg, state_dict_from_jax(_jax_params(jm)),
                                 device="cpu", warn=False)
        assert all(p.dtype == torch.bfloat16 for p in eng.model.parameters())
    else:  # fp32 weights: the engine over a model built by hand
        tm = build_backbone(tcfg, device="cpu")
        tm.load_state_dict(state_dict_from_jax(params))
        eng = PackedServeEngine(tm, serve_layout_from_cfg(tcfg), warn=False,
                                patch_features=True)
    jeng = JEngine(jm, params, j_layout(cfg), warn=False, patch_features=True)
    want, got = _drain(jeng, _images()), _drain(eng, _images())
    assert sorted(got) == sorted(want) == list(range(len(SIZES)))
    assert eng.packs_run == jeng.packs_run >= 2
    scale = max(np.abs(r.cls_feature).max() for r in want.values())
    tol = 1e-4 if dtype == "fp32" else 2.0 ** -5 * scale
    for i, w in want.items():
        g = got[i]
        assert g.n_patches == w.n_patches
        for field in ("cls_feature", "pooled_patch_feature", "patch_tokens"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.shape == b.shape and np.isfinite(a).all(), field
            np.testing.assert_allclose(a, b, atol=tol,
                                       err_msg=f"{field}, request {i}")


def test_serving_cast_is_bitwise_the_jax_cast():
    from dinov3_tpu.models import build_backbone as jax_build
    from dinov3_tpu.serve import cast_serving_tree as jax_cast

    from dinov3_tpu_torch.serve import cast_serving_tree, load_serving_model

    cfg, tcfg = _cfgs()
    params = _jax_params(jax_build(cfg, teacher=True))
    want = state_dict_from_jax(jax_cast(params))
    got = cast_serving_tree(state_dict_from_jax(params))
    assert cast_serving_tree(got).keys() == got.keys()  # idempotent
    model = load_serving_model(tcfg, state_dict_from_jax(params), device="cpu")
    served = model.state_dict()
    for k, w in want.items():
        assert w.dtype == got[k].dtype == served[k].dtype == torch.bfloat16, k
        assert torch.equal(got[k].view(torch.int16), w.view(torch.int16)), k
        assert torch.equal(served[k].view(torch.int16), w.view(torch.int16)), k


def test_entry_points_raise_without_a_card_unless_cpu(monkeypatch):
    from dinov3_tpu_torch.models import build_backbone
    from dinov3_tpu_torch.serve import (
        OracleServeEngine,
        build_serve_engine,
        build_serve_fleet,
        load_serving_model,
    )
    from dinov3_tpu_torch.serve.bench import main as bench_main

    _, tcfg = _cfgs()
    _, oracle_cfg = _cfgs(["serve.continuous_packing=false"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry, cfg in ((build_serve_engine, tcfg), (load_serving_model, tcfg),
                       (build_backbone, tcfg), (build_serve_engine, oracle_cfg),
                       (build_serve_fleet, tcfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_main(["--smoke", "--out", os.devnull])
    oracle = build_serve_engine(oracle_cfg, device="cpu", warn=False)
    assert isinstance(oracle, OracleServeEngine)
    assert next(oracle.model.parameters()).device.type == "cpu"
    fleet = build_serve_fleet(tcfg, device="cpu", warn=False)
    assert len(_drain(fleet, _images()[:2])) == 2
    eng = build_serve_engine(tcfg, device="cpu", warn=False)
    assert next(eng.model.parameters()).device.type == "cpu"
    out = _drain(eng, _images()[:3])
    assert len(out) == 3 and all(np.isfinite(r.cls_feature).all()
                                 for r in out.values())
    stats = eng._ring.host_slot(0)["stats"]
    assert stats[0] == sum(1 + (h // 4) * (w // 4) for h, w in SIZES[:3])
