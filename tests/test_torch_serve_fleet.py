"""The rest of the port's serving plane against the JAX package's, on the
CPU at ``vit_test`` size with the ``SERVE_SMOL`` overrides of
``tests/test_torch_serve.py``: int8 quantization and the int8 engine, the
oracle engines, the feature cache, the fleet router and
``build_serve_fleet``, the ``ckpt_dir`` entry, the fetch funnel and the
bench CLI. The JAX engines
run K1 in Pallas interpret mode (``kernels.flash_attention=pallas``).

Tolerances, named at each use:
- bitwise: int8 codes, scales and dequantized weights, image keys, LRU
  counters, routes, fingerprints' stability, cache hits against their
  misses, a one-engine fleet against its bare engine, the ``ckpt_dir``
  builds;
- bf16 features: 2^-5 of the largest feature magnitude (about 8 bf16
  ulps, as in ``tests/test_torch_serve.py``).

JAX is imported inside the tests, so the ``cuda`` cases run on the card
(``--noconftest``, no JAX there).
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(8, 8), (16, 16), (12, 8), (24, 16), (8, 12), (16, 24), (20, 20),
         (8, 20), (16, 16), (8, 8), (12, 8)]
BF16_REL = 2.0 ** -5


def _images(seed=2, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, w, 3)).astype(np.float32) for h, w in sizes]


def _drain(engine, images):
    for i, im in enumerate(images):
        engine.submit(im, request_id=i)
    out = []
    while engine.queue_len:
        out.extend(engine.flush())
    return {r.request_id: r for r in out}


def _close(got: dict, want: dict, what: str) -> None:
    """bf16 features within 2^-5 of the largest magnitude."""
    assert sorted(got) == sorted(want)
    scale = max(np.abs(r.cls_feature).max() for r in want.values())
    for i, w in want.items():
        g = got[i]
        assert g.n_patches == w.n_patches
        for field in ("cls_feature", "pooled_patch_feature"):
            a, b = getattr(g, field), getattr(w, field)
            assert np.isfinite(a).all(), (what, field, i)
            np.testing.assert_allclose(a, b, atol=BF16_REL * scale,
                                       err_msg=f"{what} {field} request {i}")


@pytest.fixture(scope="module")
def sides():
    """(JAX cfg, port cfg, JAX model, JAX bf16 serving tree, the port's
    bf16 serving model of the same weights, layouts)."""
    import warnings

    from dinov3_tpu.models import build_backbone as jax_build
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh
    from dinov3_tpu.serve import cast_serving_tree as jax_cast
    from dinov3_tpu.serve import serve_layout_from_cfg as j_layout
    from test_torch_serve import _cfgs, _jax_params

    from dinov3_tpu_torch.interop import state_dict_from_jax
    from dinov3_tpu_torch.serve import load_serving_model, serve_layout_from_cfg

    prev = get_current_mesh()
    set_current_mesh(None)
    cfg, tcfg = _cfgs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jax_build(cfg, teacher=True)
    params = _jax_params(jm)
    model = load_serving_model(tcfg, state_dict_from_jax(params), device="cpu")
    yield types.SimpleNamespace(
        cfg=cfg, tcfg=tcfg, jm=jm, jparams=jax_cast(params), model=model,
        jlayout=j_layout(cfg), layout=serve_layout_from_cfg(tcfg))
    set_current_mesh(prev)


@pytest.fixture(scope="module")
def qtree(sides):
    from dinov3_tpu.serve import quantize_serving_tree

    return quantize_serving_tree(sides.jparams)


# ---------------- quantization ----------------

def test_quantization_is_bitwise_the_jax_one(sides, qtree):
    """Codes and scales from the port's bf16 model equal JAX's
    ``quantize_serving_tree`` of the same bf16 tree, transposed; the
    quantized set is JAX's through the bridge's names; dequantized
    weights are equal; ``quant_summary`` has equal counts and bytes."""
    import jax.tree_util as jtu

    from dinov3_tpu.serve import QuantLeaf
    from dinov3_tpu.serve import dequantize_tree as j_dequant
    from dinov3_tpu.serve import quant_summary as j_summary

    from dinov3_tpu_torch.interop import quant_state_from_jax, state_dict_from_jax
    from dinov3_tpu_torch.serve import (
        dequantize_state_dict,
        quant_summary,
        quantizable_path,
        quantize_serving_model,
        quantize_state_dict,
    )

    got = quantize_state_dict(sides.model.state_dict())
    want = quant_state_from_jax(qtree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        if w.dtype == torch.bfloat16:
            assert torch.equal(got[k].view(torch.int16), w.view(torch.int16)), k
        else:
            assert torch.equal(got[k], w), k
    # the JAX codes themselves, transposed: [in, out] -> [out, in]
    leaf = qtree["blocks_0"]["attn"]["qkv_kernel"]
    assert isinstance(leaf, QuantLeaf)
    assert np.array_equal(got["blocks.0.attn.qkv.q"].numpy(), np.asarray(leaf.q).T)
    assert np.array_equal(got["blocks.0.attn.qkv.scale"].numpy(),
                          np.asarray(leaf.scale).T)
    assert int(got["blocks.0.attn.qkv.q"].abs().max()) == 127
    # the quantized set through the bridge's names
    jax_names = set()
    for path, leaf in jtu.tree_flatten_with_path(
            qtree, is_leaf=lambda x: isinstance(x, QuantLeaf))[0]:
        if isinstance(leaf, QuantLeaf):
            keys = [str(getattr(k, "key", k)) for k in path]
            jax_names.add("/".join(keys))
    port_names = {k for k in sides.model.state_dict() if quantizable_path(k)}
    assert len(port_names) == len(jax_names) == 8
    assert {k[: -len(".weight")] + ".q" for k in port_names} == \
        {k for k, v in want.items() if v.dtype == torch.int8}
    # dequantized weights, bitwise
    dense = dequantize_state_dict(got)
    jdense = state_dict_from_jax(j_dequant(qtree))
    assert dense.keys() == jdense.keys()
    for k, w in jdense.items():
        assert torch.equal(dense[k].view(torch.int16), w.view(torch.int16)), k
    qmodel = quantize_serving_model(sides.model)
    assert quant_summary(qmodel) == j_summary(qtree)
    assert quant_summary(sides.model) == j_summary(sides.jparams)
    for k, v in qmodel.state_dict().items():  # the int8 model holds the codes
        if k.endswith((".q", ".scale")):
            assert torch.equal(v, got[k]), k
    # the bf16 model is left alone, and quantizing twice is a no-op
    assert not any(k.endswith(".q") for k in sides.model.state_dict())
    assert quantize_serving_model(qmodel) is qmodel


def test_int8_engine_matches_the_jax_int8_engine(sides, qtree):
    """The packed engine on the int8 model against JAX's packed engine on
    its int8 tree: bf16 tolerance; the int8 model built from the bridged
    JAX codes serves the same features bitwise as the port's own."""
    from dinov3_tpu.serve import PackedServeEngine as JEngine

    from dinov3_tpu_torch.interop import quant_state_from_jax
    from dinov3_tpu_torch.serve import PackedServeEngine, quantize_serving_model

    jeng = JEngine(sides.jm, qtree, sides.jlayout, warn=False)
    assert jeng.arm == "packed_int8"
    want = _drain(jeng, _images())
    got = {}
    for name, qmodel in (
            ("port codes", quantize_serving_model(sides.model)),
            ("bridged codes", quantize_serving_model(sides.model,
                                                     quant_state_from_jax(qtree)))):
        eng = PackedServeEngine(qmodel, sides.layout, warn=False)
        assert (eng.arm, eng.weights_dtype, eng.compile_count) == ("packed_int8", "int8", 1)
        got[name] = _drain(eng, _images())
        assert eng.packs_run == jeng.packs_run
        _close(got[name], want, f"int8 engine ({name})")
    for i, r in got["port codes"].items():
        assert np.array_equal(r.cls_feature, got["bridged codes"][i].cls_feature)


def test_quant_feature_drift_against_jax(sides, qtree):
    """The drift probe: same keys, both drifts within the default
    tolerance; the int8 model's features leave the bf16 ones (codes
    really are used)."""
    from dinov3_tpu.serve import quant_feature_drift as j_drift

    from dinov3_tpu_torch.serve import quant_feature_drift, quantize_serving_model

    got = quant_feature_drift(sides.model, quantize_serving_model(sides.model), px=16)
    want = j_drift(sides.jm, sides.jparams, qtree, px=16)
    assert got.keys() == want.keys() and got["probe_px"] == 16
    assert 0.0 < got["cls_max_abs_diff"] <= 0.05
    assert want["cls_max_abs_diff"] <= 0.05


# ---------------- the oracle engines ----------------

@pytest.mark.parametrize("mode", ["per_image", "rectangular"])
def test_oracle_matches_the_jax_oracle(sides, mode):
    """Both oracle modes over the same two flushes: features within the
    bf16 tolerance, ``compile_count`` equal to the JAX jit cache's, pad
    waste equal."""
    from dinov3_tpu.serve import OracleServeEngine as JOracle

    from dinov3_tpu_torch.serve import OracleServeEngine

    jeng = JOracle(sides.jm, sides.jparams, sides.jlayout, mode=mode)
    eng = OracleServeEngine(sides.model, sides.layout, mode=mode)
    assert eng.arm == jeng.arm == f"oracle_{mode}"
    images = _images(sizes=[(8, 8), (16, 12), (8, 8), (8, 8), (16, 12)])
    want, got = {}, {}
    for lo, hi in ((0, 3), (3, 5)):
        for e, out in ((jeng, want), (eng, got)):
            for i in range(lo, hi):
                e.submit(images[i], request_id=i)
            out.update({r.request_id: r for r in e.flush()})
            assert e.queue_len == 0
    _close(got, want, f"oracle {mode}")
    assert eng.compile_count == jeng.compile_count == (2 if mode == "per_image" else 3)
    assert eng.packs_run == jeng.packs_run == 2
    assert eng.mean_pad_waste == pytest.approx(jeng.mean_pad_waste, abs=0)
    eng.reset_pad_stats()
    assert eng.mean_pad_waste is None


def test_flush_policy_equals_jax(sides):
    """``should_flush`` and ``flush_deadline`` of both engines equal the
    JAX engines' on the same admissions, at every probe time."""
    from dinov3_tpu.serve import OracleServeEngine as JOracle

    from dinov3_tpu_torch.serve import OracleServeEngine, PackedServeEngine

    ours = [PackedServeEngine(sides.model, sides.layout, flush_ms=5.0, warn=False),
            OracleServeEngine(sides.model, sides.layout, flush_ms=5.0)]
    theirs = JOracle(sides.jm, sides.jparams, sides.jlayout, flush_ms=5.0)
    assert [e.flush_deadline() for e in ours] == [theirs.flush_deadline()] * 2 == [None, None]
    rng = np.random.default_rng(8)
    t = 0.0
    for i, im in enumerate(_images(seed=4) * 2):
        t += float(rng.exponential(0.002))
        for e in ours + [theirs]:
            e.submit(im, request_id=i, arrival_s=t)
        for now in (t, t + 0.001, t + 0.0049, t + 0.005, t + 0.02):
            want = theirs.should_flush(now)
            assert [e.should_flush(now) for e in ours] == [want, want], (i, now)
        assert [e.flush_deadline() for e in ours] == [theirs.flush_deadline()] * 2


# ---------------- the feature cache ----------------

def test_image_key_and_lru_counters_equal_jax(sides):
    """``image_key`` is JAX's bitwise; the same operations on both caches
    give the same counters, stats, evictions and contents order."""
    from dinov3_tpu.serve import FeatureCache as JCache
    from dinov3_tpu.serve import image_key as j_key

    from dinov3_tpu_torch.serve import FeatureCache, image_key

    imgs = _images(seed=5)
    for im in imgs + [im.astype(np.float64) for im in imgs[:2]] + [imgs[0].reshape(-1, 8, 3)]:
        assert image_key(im) == j_key(im)
    ours, theirs = FeatureCache(3), JCache(3)
    rng = np.random.default_rng(9)
    for step in range(40):
        im = imgs[int(rng.integers(len(imgs)))]
        for c in (ours, theirs):
            key = c.key(im, "fp")
            if c.get(key) is None:
                ev = c.put(key, (np.full(4, step, np.float32), np.zeros(4, np.float32), 9))
                if c is ours:
                    ev_ours = ev
                else:
                    assert ev == ev_ours
        assert ours.stats() == theirs.stats()
    assert list(ours._d) == list(theirs._d)
    hit = ours.get(next(iter(ours._d)))
    assert not hit[0].flags.writeable
    ours.clear(reset_counters=True)
    assert ours.stats()["hits"] == 0 and len(ours) == 0
    with pytest.raises(ValueError):
        FeatureCache(0)


def test_weights_fingerprint_stable_and_per_model(sides):
    from dinov3_tpu_torch.serve import quantize_serving_model, weights_fingerprint

    f_bf16 = weights_fingerprint(sides.model)
    f_int8 = weights_fingerprint(quantize_serving_model(sides.model))
    assert f_bf16 == weights_fingerprint(sides.model) == \
        weights_fingerprint(copy.deepcopy(sides.model).state_dict())
    assert f_int8 == weights_fingerprint(quantize_serving_model(sides.model))
    assert f_bf16 != f_int8 and len(f_bf16) == 16
    other = copy.deepcopy(sides.model)
    with torch.no_grad():
        other.norm.bias[0] += 1
    assert weights_fingerprint(other) != f_bf16


# ---------------- the fleet ----------------

def _stub(layout):
    return types.SimpleNamespace(layout=layout)


def test_router_decisions_equal_jax(sides):
    """``FleetRouter.route`` over a grid of (slo, h, w) and three pools:
    the same engine chosen, the same refusals."""
    from dinov3_tpu.serve import EngineSpec as JSpec
    from dinov3_tpu.serve import FleetRouter as JRouter

    from dinov3_tpu_torch.serve import EngineSpec, FleetRouter

    L, JL = sides.layout, sides.jlayout
    small = dict(rows=2, row_tokens=20, max_segments_per_row=3, max_px=16)
    tiny = dict(rows=4, row_tokens=10, max_segments_per_row=2, max_px=12)
    pools = [
        [("fast", small, ("interactive",)), ("full", {}, None)],
        [("full", {}, None), ("tiny", tiny, None), ("fast", small, ("interactive", "batch"))],
        [("only_batch", small, ("batch",))],
    ]
    grid = [(slo, h, w) for slo in ("interactive", "batch", "default")
            for h in (4, 8, 10, 12, 16, 24, 28) for w in (8, 16, 24)]
    for pool in pools:
        ours = FleetRouter([EngineSpec(n, _stub(dataclasses.replace(L, **kw)), slo, "f")
                            for n, kw, slo in pool])
        theirs = JRouter([JSpec(n, _stub(dataclasses.replace(JL, **kw)), slo, "f")
                          for n, kw, slo in pool])
        for slo, h, w in grid:
            try:
                want = theirs.route(slo, h, w).name
            except ValueError:
                with pytest.raises(ValueError, match="no engine admits"):
                    ours.route(slo, h, w)
                continue
            assert ours.route(slo, h, w).name == want, (pool, slo, h, w)
    with pytest.raises(ValueError, match="duplicate"):
        FleetRouter([EngineSpec("a", _stub(L), None, "f")] * 2)


def test_single_engine_fleet_is_the_bare_engine_bitwise(sides):
    from dinov3_tpu_torch.serve import EngineSpec, FleetRouter, PackedServeEngine

    bare = _drain(PackedServeEngine(sides.model, sides.layout, warn=False), _images())
    fleet = FleetRouter([EngineSpec("solo", PackedServeEngine(sides.model, sides.layout,
                                                              warn=False))])
    got = _drain(fleet, _images())
    assert sorted(got) == sorted(bare)
    for i, r in bare.items():
        assert got[i].engine == "solo" and not got[i].cache_hit
        assert np.array_equal(got[i].cls_feature, r.cls_feature)
        assert np.array_equal(got[i].pooled_patch_feature, r.pooled_patch_feature)
    assert fleet.compile_count == 1


def test_fleet_replay_cache_hits_are_bitwise_their_misses(sides):
    """A rated replay of repeated content through a two-engine fleet
    (int8 fast lane, bf16 row) with the cache in front: every hit
    bitwise its miss, the observer's cache events add up, compiles stay
    at the engine count."""
    from dinov3_tpu_torch.serve import (
        EngineSpec,
        FeatureCache,
        FleetRouter,
        PackedServeEngine,
        quantize_serving_model,
    )
    from dinov3_tpu_torch.serve.bench import fleet_rated_replay, make_mix, repeat_trace
    from dinov3_tpu_torch.telemetry import ServeObserver

    L = sides.layout
    small = dataclasses.replace(L, rows=2, row_tokens=20, max_segments_per_row=3,
                                max_px=16)
    obs = ServeObserver(None, L, slo_classes=(), warn=False)
    router = FleetRouter([
        EngineSpec("fast", PackedServeEngine(quantize_serving_model(sides.model), small,
                                             warn=False), ("interactive",)),
        EngineSpec("full", PackedServeEngine(sides.model, L, warn=False))],
        cache=FeatureCache(64), observer=obs)
    rng = np.random.default_rng(10)
    fresh = make_mix(rng, [(0.6, (8, 16)), (0.4, (20, 24))], 12, 4)
    seq = repeat_trace(rng, fresh, 30, 0.5)
    trace = [(float(a), im) for a, im in zip(np.cumsum(rng.exponential(0.003, 30)), seq)]
    responses, audit = fleet_rated_replay(router, trace, L)
    assert len(responses) == 30 and audit["hits"] > 0
    assert audit["bitwise_failures"] == 0
    stats = router.cache.stats()
    assert stats["hits"] == audit["hits"] == obs.cache_events["hit"]
    assert stats["misses"] == obs.cache_events["miss"] == 30 - audit["hits"]
    assert router.compile_count == 2
    assert {r.engine for r in responses} == {"fast", "full"}
    assert sum(obs.route_counts.values()) == 30
    fin = router.finalize()
    assert fin["n_engines"] == 2 and fin["cache"]["hit_rate"] == stats["hit_rate"]


def test_build_serve_fleet_equals_jax(sides):
    """From the same overlays: the same engine names, layouts, SLO
    contracts and quant flags as JAX's fleet; one shared int8 model, the
    cache on, the drift probe under its tolerance, no guardrail fired."""
    import warnings

    from dinov3_tpu.serve import build_serve_fleet as j_fleet

    from dinov3_tpu_torch.interop import state_dict_from_jax
    from dinov3_tpu_torch.serve import build_serve_fleet
    from test_torch_serve import _jax_params

    engines = [
        {"name": "fast_int8", "slo": "interactive", "quant": True,
         "rows": 2, "row_tokens": 20, "max_segments_per_row": 3, "max_px": 16},
        {"name": "full_bf16"},
        {"name": "batch_int8", "slo": "batch", "quant": True, "flush_ms": 3},
    ]
    cfg, tcfg = copy.deepcopy(sides.cfg), copy.deepcopy(sides.tcfg)
    cfg.serve.fleet.engines = copy.deepcopy(engines)
    tcfg.serve.fleet.engines = copy.deepcopy(engines)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ours = build_serve_fleet(tcfg, state_dict_from_jax(_jax_params(sides.jm)),
                                 device="cpu", warn=True)
    bad = [str(w.message) for w in caught
           if "quant drift axis" in str(w.message) or "cache memory axis" in str(w.message)]
    assert not bad, bad
    theirs = j_fleet(cfg, params=_jax_params(sides.jm), warn=False)
    assert [s.name for s in ours.specs] == [s.name for s in theirs.specs]
    for a, b in zip(ours.specs, theirs.specs):
        assert dataclasses.asdict(a.engine.layout) == dataclasses.asdict(b.engine.layout)
        assert (a.slo_classes, a.engine.arm, a.engine.weights_dtype) == \
            (b.slo_classes, b.engine.arm, b.engine.weights_dtype)
        assert a.engine.batcher.flush_ms == b.engine.batcher.flush_ms
    fast, full, batch = ours.specs
    assert fast.engine.model is batch.engine.model is not full.engine.model
    assert fast.fingerprint == batch.fingerprint != full.fingerprint
    assert ours.compile_count == theirs.compile_count == 3
    assert (ours.cache is None) == (theirs.cache is None) is False
    assert ours.cache.capacity == theirs.cache.capacity
    assert ours.quant_drift.keys() == theirs.quant_drift.keys()
    assert ours.quant_drift["cls_max_abs_diff"] <= 0.05
    tcfg.serve.fleet.engines = None
    tcfg.serve.cache.enabled = False
    solo = build_serve_fleet(tcfg, device="cpu", warn=False)
    assert [s.name for s in solo.specs] == ["default"] and solo.cache is None
    assert solo.quant_drift is None


def test_layout_from_envelope_admits_the_observed_mix(sides):
    from dinov3_tpu.serve import layout_from_envelope as j_from_env

    from dinov3_tpu_torch.serve import layout_from_envelope
    from dinov3_tpu_torch.serve.bench import derive_fast_envelope, make_mix, slo_class

    images = make_mix(np.random.default_rng(11), [(1.0, (8, 24))], 40, 4)
    env = derive_fast_envelope(images, sides.layout)
    fast = layout_from_envelope(sides.layout, env)
    assert dataclasses.asdict(fast) == dataclasses.asdict(j_from_env(sides.jlayout, env))
    assert all(fast.admits(*im.shape[:2]) for im in images
               if slo_class(im, sides.layout) == "interactive")


# ---------------- entry points ----------------

def test_build_serve_engine_from_ckpt_dir_equals_the_state_dict_build(sides, tmp_path):
    """``build_serve_engine(cfg, ckpt_dir=...)`` over a port checkpoint
    and over a JAX local-npz checkpoint serves bitwise what the
    ``state_dict`` build of the teacher serves; with
    ``serve.continuous_packing=false`` it builds the oracle
    ``serve.oracle`` names."""
    import jax.numpy as jnp

    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from dinov3_tpu.train.train_step import TrainState
    from test_torch_evals import trainer_cfg
    from test_torch_serve import SERVE_SMOL, _jax_params
    from test_torch_trainer import small_setup

    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.interop import state_dict_from_jax
    from dinov3_tpu_torch.serve import OracleServeEngine, build_serve_engine

    setup, batch = small_setup()
    state, _ = setup.step_fn(setup.state, batch, setup.scalars(0))
    Checkpointer(tmp_path / "port").save(1, state)
    port_cfg = trainer_cfg(SERVE_SMOL)
    port_teacher = {k[len("backbone."):]: v for k, v in state.meta.teacher.state_dict().items()
                    if k.startswith("backbone.")}
    jax_teacher = _jax_params(sides.jm, seed=4)
    jstate = TrainState({"student": {"backbone": _jax_params(sides.jm, seed=5)},
                         "teacher": {"backbone": jax_teacher}}, {}, {},
                        jnp.asarray(3, jnp.int32))
    ckpt = JaxCheckpointer(str(tmp_path / "jax"), async_save=False)
    try:
        ckpt._local_save(3, jstate)
    finally:
        ckpt.close()
    for cfg, ckpt_dir, teacher in ((port_cfg, tmp_path / "port", port_teacher),
                                   (sides.tcfg, tmp_path / "jax",
                                    state_dict_from_jax(jax_teacher))):
        got = _drain(build_serve_engine(cfg, ckpt_dir=str(ckpt_dir), device="cpu",
                                        warn=False), _images()[:5])
        want = _drain(build_serve_engine(cfg, teacher, device="cpu", warn=False),
                      _images()[:5])
        assert sorted(got) == sorted(want) == list(range(5))
        for i, w in want.items():
            assert np.array_equal(got[i].cls_feature, w.cls_feature), (ckpt_dir, i)
            assert np.array_equal(got[i].pooled_patch_feature, w.pooled_patch_feature)
    tcfg = copy.deepcopy(sides.tcfg)
    tcfg.serve.continuous_packing = False
    for mode in ("per_image", "rectangular"):
        tcfg.serve.oracle = mode
        eng = build_serve_engine(tcfg, ckpt_dir=str(tmp_path / "jax"), device="cpu")
        assert isinstance(eng, OracleServeEngine) and eng.mode == mode


def test_fetches_equal_packs_run(sides):
    """With an observer attached, the packed engine makes one counted
    fetch a pack; the oracle one a (h, w) group."""
    from dinov3_tpu_torch.serve import OracleServeEngine, PackedServeEngine
    from dinov3_tpu_torch.telemetry import ServeObserver, host_sync_stats

    for eng in (PackedServeEngine(sides.model, sides.layout, warn=False),
                OracleServeEngine(sides.model, sides.layout)):
        eng.observer = ServeObserver(None, sides.layout, warn=False)
        host_sync_stats(reset=True)
        out = _drain(eng, _images())
        fetches = host_sync_stats(reset=True)["fetches"]
        assert len(out) == len(SIZES) and eng.observer.packs == eng.packs_run
        if eng.arm == "packed":
            assert fetches == eng.packs_run >= 2
        else:
            assert fetches == len(set(SIZES)) and eng.packs_run == 1


def test_bench_cli_writes_the_reference_record(tmp_path):
    """``python -m dinov3_tpu_torch.serve.bench --smoke --device cpu``
    (and ``--fleet``; at ``vit_test`` size here) write records with the
    reference's keys. The arms
    record is held against ``SERVE_r14.json`` less the HLO census fields
    (``packed_census``, ``serve_copies``, ``unattributed_copies``), plus
    what the reference's code writes since that record was taken (the
    observer's ``obs`` blocks and the per-SLO ``by_slo`` latencies); the
    fleet record against ``SERVE_r16.json``."""
    census = {"packed_census", "serve_copies", "unattributed_copies"}
    from dinov3_tpu_torch.serve.bench import main

    for flag, ref in (([], "SERVE_r14.json"), (["--fleet"], "SERVE_r16.json")):
        out = tmp_path / f"rec{len(flag)}.json"
        args = ["--smoke", "--device", "cpu", "--n", "6", "--out", str(out),
                "--obs-dir", str(tmp_path / "obs"), *flag, "student.arch=vit_test"]
        if flag:  # the fleet in this process, the arms as a child process
            assert main(args) == 0
        else:
            proc = subprocess.run(
                [sys.executable, "-m", "dinov3_tpu_torch.serve.bench", *args],
                cwd=REPO, capture_output=True, text=True, timeout=300)
            assert proc.returncode == 0, proc.stderr[-3000:]
            assert json.loads(proc.stdout[proc.stdout.index("\n{") + 1:]) == \
                json.loads(out.read_text())
        got = json.loads(out.read_text())
        with open(os.path.join(REPO, ref)) as f:
            want = json.load(f)
        if not flag:
            assert set(got) == set(want) - census | {"obs"}
            for mix, rec in want["mixes"].items():
                assert set(got["mixes"][mix]) == set(rec)
                for arm in ("packed", "oracle_rectangular", "oracle_per_image"):
                    g, w = got["mixes"][mix][arm], rec[arm]
                    assert set(g) == set(w)
                    assert set(g["serve"]) == set(w["serve"]) - census | {"obs"}
                    assert set(g["latency"]) == set(w["latency"]) | {"by_slo"}
                    assert g["serve"]["compile_count"] == (
                        1 if arm == "packed" else g["serve"]["compile_count"])
            assert got["packed_compile_count"] == 1 and got["backend"] == "cpu"
        else:
            assert set(got) == set(want)
            for key in ("quant", "quant/throughput", "quant/summary", "quant/drift_probe",
                        "fleet", "fleet/summary", "fleet/derived_fast_envelope"):
                g, w = got, want
                for part in key.split("/"):
                    g, w = g[part], w[part]
                assert set(g) == set(w), key
            for name, sweep in got["fleet"]["sweeps"].items():
                assert set(sweep) == set(want["fleet"]["sweeps"][name])
                assert sweep["cache_hits_bitwise_equal"] and sweep["compile_growth"] == 0
            assert set(got["fleet"]["summary"]) == set(want["fleet"]["summary"])
            for eng in got["fleet"]["summary"]["engines"].values():
                assert set(eng) == set(next(iter(want["fleet"]["summary"]["engines"].values())))
            assert got["fleet"]["forced_hit_bitwise"] and got["compile_count_total"] == 2


# ---------------- on the card ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _card_cfg():
    """ViT-S/4 (head dim 64, which the card's attention kernel takes) at
    the smoke envelope, LayerScale 1 so the blocks reach the features."""
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.serve.bench import SMOKE_OVERRIDES

    cfg = get_default_config()
    apply_dot_overrides(cfg, SMOKE_OVERRIDES + ["student.layerscale=1.0"])
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["packed_int8", "oracle_per_image", "oracle_rectangular"])
def test_engines_on_the_card_match_the_cpu(cuda_device, arm):
    """The int8 packed engine and both oracles on the card against the
    same engine on the CPU (the kernels' plain versions), same weights:
    features within 2^-4 of their magnitude (bf16 blocks summing in other
    orders, K1 rounding probabilities to bf16), K1 and K4 launched."""
    from dinov3_tpu_torch.ops.flash_attention import FLASH_FWD
    from dinov3_tpu_torch.ops.fused_norm import LAYERNORM_FWD
    from dinov3_tpu_torch.serve import (
        OracleServeEngine,
        PackedServeEngine,
        load_serving_model,
        quantize_serving_model,
        serve_layout_from_cfg,
    )
    from dinov3_tpu_torch.serve.bench import MIXES_SMOKE, make_mix

    cfg = _card_cfg()
    layout = serve_layout_from_cfg(cfg)
    images = make_mix(np.random.default_rng(0), MIXES_SMOKE["mixed_ragged"], 16, 4)
    out = {}
    for dev in ("cuda", "cpu"):
        model = load_serving_model(cfg, device=dev, seed=1)
        if arm == "packed_int8":
            eng = PackedServeEngine(quantize_serving_model(model), layout, warn=False)
        else:
            eng = OracleServeEngine(model, layout, mode=arm.removeprefix("oracle_"))
        k1, k4 = FLASH_FWD.launches, LAYERNORM_FWD.launches
        out[dev] = _drain(eng, images)
        if dev == "cuda":
            assert FLASH_FWD.launches > k1 and LAYERNORM_FWD.launches > k4
            assert eng.arm == arm
    scale = max(np.abs(r.cls_feature).max() for r in out["cpu"].values())
    for i, w in out["cpu"].items():
        for field in ("cls_feature", "pooled_patch_feature"):
            np.testing.assert_allclose(getattr(out["cuda"][i], field), getattr(w, field),
                                       atol=2.0 ** -4 * max(scale, 1.0))
