"""The port's evaluation path (``dinov3_tpu_torch/evals``, the eval-time
model API, the classification data and the in-run evals) against the JAX
package, on the CPU at ``vit_test`` size (patch 4, 16 px crops, a few
dozen images).

Both sides take the same seeded numpy inputs and the same weights (JAX's,
perturbed so zero-initialised leaves count, bridged by
``interop/from_jax.py``). The JAX forward runs its Pallas flash kernel in
interpret mode (``kernels.flash_attention=pallas``), as the port's tests of
the serve and training paths run it; the JAX host helpers take their numpy
paths (``tests/test_torch_data.py``). The probe's epoch orders are JAX's
``jax.random.permutation`` ones, handed across as numpy.

Tolerances:
- intermediate layers and extracted features, fp32: 2e-5;
- the serve engine's features: 1e-4, as ``tests/test_torch_serve.py``;
- images, targets, dataset indexes, k-NN predictions, weights read from
  checkpoints: exact;
- probe accuracies: equal, or within one test sample (fp32 sums in other
  orders can move one prediction across a class boundary); the sweep's
  combo against a lone probe of the port: weights within 1e-5.

JAX is imported inside the tests that use it, so the ``cuda`` case runs
on the card (where there is no JAX) with ``--noconftest``.
"""

import gc
import itertools
import json
import logging
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
EVAL_SMOL = ["student.arch=vit_test", "student.patch_size=4",
             "crops.global_crops_size=16", "compute_precision.compute_dtype=fp32",
             "kernels.flash_attention=pallas", "train.num_workers=2",
             "optim.scaling_rule=none"]
SYN_TRAIN = "Synthetic:split=TRAIN:size=64:image_size=24:n_classes=4"
SYN_VAL = "Synthetic:split=VAL:size=32:image_size=24:n_classes=4"
CHILD_TIMEOUT = 300


@pytest.fixture(autouse=True)
def _threads_loggers_and_gc_unchanged():
    """The data producer threads a test starts end with it; the port's
    logger and the collector's switch and callbacks end as they began
    (the in-run eval test checks the frozen generation itself: a first
    import of orbax by the JAX side freezes the interpreter's start-up
    objects, ``tests/test_torch_trainer.py``)."""
    from dinov3_tpu_torch.logging_utils import LOGGER_NAME

    log = logging.getLogger(LOGGER_NAME)
    before = (gc.isenabled(), list(gc.callbacks), list(log.handlers))
    yield
    for t in threading.enumerate():
        if t.name == "dinov3-data-producer":
            t.join(10)
    assert not any(t.name == "dinov3-data-producer" and t.is_alive()
                   for t in threading.enumerate()), "a data producer thread outlived its test"
    assert (gc.isenabled(), list(gc.callbacks), list(log.handlers)) == before


@pytest.fixture
def jax_side(monkeypatch):
    """The JAX package with no ambient mesh (another test may leave one)
    and its host helpers on their numpy paths."""
    from dinov3_tpu import native
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    for name in ("normalize_image", "stack_crops", "color_jitter"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)
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
    apply_dot_overrides(jcfg, EVAL_SMOL + list(extra))
    t_apply(tcfg, EVAL_SMOL + list(extra))
    return jcfg, tcfg


def models(extra=(), seed=0):
    """(JAX cfg, port cfg, JAX model, its perturbed params, the port model
    holding them)."""
    import warnings

    from dinov3_tpu.models import build_backbone as jax_build
    from test_torch_serve import _jax_params

    from dinov3_tpu_torch.interop import state_dict_from_jax
    from dinov3_tpu_torch.models import build_backbone

    jcfg, tcfg = cfgs(extra)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jax_build(jcfg, teacher=True)
    params = _jax_params(jm, seed)
    tm = build_backbone(tcfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params))
    return jcfg, tcfg, jm, params, tm.requires_grad_(False)


def leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree)]


def blobs(n_per_class, n_classes, d, seed, spread):
    """Seeded class-structured fp32 features: fixed unit centers (seed 42)
    plus ``spread`` Gaussian noise drawn from ``seed``."""
    centers = np.random.default_rng(42).standard_normal((n_classes, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    x = np.concatenate([c + spread * rng.standard_normal((n_per_class, d)).astype(np.float32)
                        for c in centers])
    y = np.repeat(np.arange(n_classes), n_per_class).astype(np.int64)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def jax_orders(n, epochs, seed=0) -> np.ndarray:
    """The epoch orders the JAX probe draws: ``permutation(split(key(seed),
    epochs)[e], n)``."""
    import jax

    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jax.random.split(jax.random.key(seed), epochs)])


# ---------------- the eval-time model API ----------------

FLAGS = list(itertools.product((False, True), repeat=4))


@pytest.mark.parametrize("n", [2, [1, 0]], ids=["last2", "list10"])
@pytest.mark.parametrize("extra", [[], ["student.n_storage_tokens=2",
                                        "student.untie_cls_and_patch_norms=true"]],
                         ids=["tied", "storage2_untied"])
def test_get_intermediate_layers_matches_jax(jax_side, n, extra):
    """Every combination of reshape, return_class_token,
    return_extra_tokens and norm: the same structure and shapes, values
    within 2e-5."""
    import jax.numpy as jnp

    _, _, jm, params, tm = models(extra)
    x = np.random.default_rng(3).standard_normal((3, 16, 12, 3)).astype(np.float32)
    for reshape, cls, ext, norm in FLAGS:
        kw = dict(reshape=reshape, return_class_token=cls, return_extra_tokens=ext,
                  norm=norm)
        want = jm.apply({"params": params}, jnp.asarray(x), n,
                        method="get_intermediate_layers", **kw)
        with torch.no_grad():
            got = tm.get_intermediate_layers(torch.from_numpy(x), n, **kw)
        assert isinstance(got, tuple) and len(got) == len(want), kw
        for a, b in zip(leaves(got), leaves(want)):
            assert a.shape == b.shape, kw
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0, err_msg=str(kw))


def test_get_intermediate_layers_refuses_out_of_range_blocks():
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.models import build_backbone

    cfg = get_default_config()
    apply_dot_overrides(cfg, EVAL_SMOL)
    model = build_backbone(cfg, device="cpu")
    x = torch.zeros(1, 16, 16, 3)
    for n in ([0, 2], [-1], 3):
        with pytest.raises(ValueError, match="out of range"):
            model.get_intermediate_layers(x, n)


# ---------------- classification data ----------------

def test_classification_transforms_and_synthetic_images_are_bitwise_the_jax_ones(jax_side):
    """``SyntheticImages`` of both splits through each classification
    transform, and their targets: the JAX dataset's, bit for bit."""
    from dinov3_tpu.data.datasets import SyntheticImages as JSynthetic
    from dinov3_tpu.data.transforms import (
        make_classification_eval_transform as j_eval,
        make_classification_train_transform as j_train,
    )

    from dinov3_tpu_torch.data.datasets import SyntheticImages
    from dinov3_tpu_torch.data.transforms import (
        make_classification_eval_transform,
        make_classification_train_transform,
    )

    pairs = [(make_classification_train_transform(crop_size=16), j_train(crop_size=16)),
             (make_classification_eval_transform(resize_size=18, crop_size=16),
              j_eval(resize_size=18, crop_size=16)),
             (None, None)]
    for split in ("TRAIN", "VAL"):
        for ours_t, theirs_t in pairs:
            kw = dict(size=12, image_size=24, n_classes=5, split=split, seed=3)
            ours = SyntheticImages(transform=ours_t, **kw)
            theirs = JSynthetic(transform=theirs_t, **kw)
            assert len(ours) == len(theirs) == 12
            np.testing.assert_array_equal(ours.get_targets(), theirs.get_targets())
            for i in range(len(ours)):
                (a, ta), (b, tb) = ours[i], theirs[i]
                a, b = np.asarray(a), np.asarray(b)
                assert ta == tb and a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    # the splits draw from distinct index universes
    a = np.asarray(SyntheticImages(size=2, image_size=8, split="TRAIN")[0][0])
    b = np.asarray(SyntheticImages(size=2, image_size=8, split="VAL")[0][0])
    assert not np.array_equal(a, b)


def test_imagenet_tree_reads_as_the_jax_dataset_does(jax_side, tmp_path):
    """A fabricated 3-class ``train`` tree of tiny JPEGs: the same entries,
    class ids and targets as the JAX dataset (each side building the index
    in its own ``extra/``, and each reading the other's), and the same
    decoded, transformed images."""
    from PIL import Image

    from dinov3_tpu.data.datasets import ImageNet as JImageNet
    from dinov3_tpu.data.transforms import make_classification_eval_transform as j_eval

    from dinov3_tpu_torch.data.loaders import make_dataset
    from dinov3_tpu_torch.data.transforms import make_classification_eval_transform

    rng = np.random.default_rng(0)
    for c, wnid in enumerate(("n03", "n01", "n02")):
        d = tmp_path / "in1k" / "train" / wnid
        d.mkdir(parents=True)
        for j in range(2 + c):
            arr = rng.integers(0, 256, (20 + 2 * j, 24, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"{wnid}_{j}.JPEG", quality=90)
    root = str(tmp_path / "in1k")
    ours = make_dataset(f"ImageNet:split=TRAIN:root={root}:extra={tmp_path / 'x_port'}",
                        transform=make_classification_eval_transform(18, 16), seed=2)
    theirs = JImageNet(split="TRAIN", root=root, extra=str(tmp_path / "x_jax"),
                       transform=j_eval(18, 16), seed=2)
    assert len(ours) == len(theirs) == 9
    np.testing.assert_array_equal(ours._get_entries(), theirs._get_entries())
    assert ours.get_class_ids() == theirs.get_class_ids() == ["n01", "n02", "n03"]
    np.testing.assert_array_equal(ours.get_targets(), theirs.get_targets())
    for i in range(len(ours)):
        (a, ta), (b, tb) = ours[i], theirs[i]
        assert ta == tb
        np.testing.assert_array_equal(a, b)
    # each side reads the index the other cached
    swapped = make_dataset(f"ImageNet:split=TRAIN:root={root}:extra={tmp_path / 'x_jax'}")
    np.testing.assert_array_equal(swapped._get_entries(), theirs._get_entries())
    assert JImageNet(split="TRAIN", root=root,
                     extra=str(tmp_path / "x_port")).get_class_ids() == ours.get_class_ids()
    with pytest.raises(FileNotFoundError):
        len(make_dataset(f"ImageNet:split=VAL:root={root}"))


def test_make_dataset_reads_int_kwargs_and_names_what_waits():
    from dinov3_tpu_torch.data.loaders import make_dataset

    ds = make_dataset("Synthetic:split=VAL:size=7:image_size=9:n_classes=3", seed=1)
    assert (len(ds), ds.image_size, ds.n_classes, ds.seed) == (7, 9, 3, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP M12"):
        make_dataset("ADE20K:root=/nowhere")
    with pytest.raises(ValueError, match="unknown dataset"):
        make_dataset("Nope:size=3")


# ---------------- features ----------------

def test_extract_features_matches_jax_with_a_ragged_tail(jax_side):
    """10 images in batches of 4 (a tail of 2): the JAX harness's features
    within 2e-5, and the port's ragged run equal to its one 10-image batch
    within 2e-5."""
    from dinov3_tpu.evals.features import extract_features as jax_extract

    from dinov3_tpu_torch.evals import extract_features, make_feature_fn

    _, _, jm, params, tm = models()
    rng = np.random.default_rng(3)
    full = rng.standard_normal((10, 16, 16, 3)).astype(np.float32)
    labels = np.arange(10)

    def batches(bs):
        for i in range(0, 10, bs):
            yield {"image": full[i:i + bs], "label": labels[i:i + bs]}

    want, want_labels = jax_extract(jm, {"params": params}, batches(4))
    got, got_labels = extract_features(tm, batches(4))
    assert got.shape == (10, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    one = make_feature_fn(tm)(torch.from_numpy(full)).numpy()
    np.testing.assert_allclose(got, one, atol=2e-5, rtol=0)
    capped, capped_labels = extract_features(tm, batches(4), max_batches=2)
    assert capped.shape == (8, 64) and list(capped_labels) == list(range(8))
    with pytest.raises(ValueError, match="no batches"):
        extract_features(tm, iter([]))


def test_extract_features_serve_matches_the_jax_engine(jax_side):
    """Four images of four resolutions through each side's packed engine:
    submission order kept, features within the engine tolerance."""
    from dinov3_tpu.evals.features import extract_features_serve as jax_serve
    from dinov3_tpu.serve import PackedServeEngine as JEngine
    from dinov3_tpu.serve import serve_layout_from_cfg as j_layout
    from test_torch_serve import SERVE_SMOL

    from dinov3_tpu_torch.evals import extract_features_serve
    from dinov3_tpu_torch.serve import PackedServeEngine, serve_layout_from_cfg

    jcfg, tcfg, jm, params, tm = models(SERVE_SMOL)
    rng = np.random.default_rng(4)
    images = [rng.standard_normal((h, w, 3)).astype(np.float32)
              for h, w in ((8, 8), (16, 16), (12, 16), (24, 24))]
    want, want_labels = jax_serve(JEngine(jm, params, j_layout(jcfg), warn=False),
                                  iter(images), iter([7, 8, 9, 10]))
    eng = PackedServeEngine(tm, serve_layout_from_cfg(tcfg), warn=False)
    got, got_labels = extract_features_serve(eng, iter(images), iter([7, 8, 9, 10]))
    assert got.shape == (4, 64) and list(got_labels) == [7, 8, 9, 10]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _, zeros = extract_features_serve(eng, iter(images[:2]))
    assert list(zeros) == [0, 0]


# ---------------- k-NN and the linear probe ----------------

@pytest.mark.parametrize("spread,k,chunk", [(0.6, 10, 1024), (0.9, 20, 16), (0.9, 3, 7)])
def test_knn_predictions_equal_jax(jax_side, spread, k, chunk):
    from dinov3_tpu.evals.knn import knn_classify as jax_knn
    from dinov3_tpu.evals.knn import knn_eval_multi as jax_multi

    from dinov3_tpu_torch.evals import knn_classify, knn_eval, knn_eval_multi

    tx, ty = blobs(40, 6, 16, seed=0, spread=spread)
    vx, vy = blobs(15, 6, 16, seed=1, spread=spread)
    want = np.asarray(jax_knn(tx, ty, vx, 6, k=k, chunk=chunk))
    got = knn_classify(tx, ty, vx, 6, k=k, chunk=chunk, device="cpu")
    assert got.shape == (90,)
    np.testing.assert_array_equal(got, want)
    assert 0.0 < (got == vy).mean() < 1.0  # the case is not trivial
    assert knn_eval(tx, ty, vx, vy, 6, k=k, device="cpu") == float((want == vy).mean())
    multi = knn_eval_multi(tx, ty, vx, vy, 6, device="cpu")
    assert multi == jax_multi(tx, ty, vx, vy, 6)
    # k above the train rows takes them all
    few = knn_classify(tx[:5], ty[:5], vx, 6, k=50, device="cpu")
    np.testing.assert_array_equal(few, np.asarray(jax_knn(tx[:5], ty[:5], vx, 6, k=50)))


@pytest.mark.parametrize("lr,wd,batch", [(0.1, 0.0, 64), (0.5, 1e-2, 64), (0.05, 3e-2, 300)])
def test_linear_probe_eval_matches_jax_with_its_orders(jax_side, lr, wd, batch):
    """The same epoch orders (JAX's), with and without the decayed-weight
    term (on w and b): accuracies within one test sample."""
    from dinov3_tpu.evals.linear import linear_probe_eval as jax_probe

    from dinov3_tpu_torch.evals import linear_probe_eval

    tx, ty = blobs(50, 5, 16, seed=0, spread=0.9)
    vx, vy = blobs(20, 5, 16, seed=1, spread=0.9)
    epochs = 4
    want = jax_probe(tx, ty, vx, vy, 5, epochs=epochs, batch_size=batch, lr=lr,
                     weight_decay=wd, seed=3)
    got = linear_probe_eval(tx, ty, vx, vy, 5, epochs=epochs, batch_size=batch, lr=lr,
                            weight_decay=wd, orders=jax_orders(250, epochs, seed=3),
                            device="cpu")
    assert abs(got - want) <= 1 / len(vy) + 1e-12, (got, want)
    assert 0.3 < got < 1.0


def test_linear_probe_sweep_matches_jax_with_its_orders(jax_side):
    """A 3 lr x 2 wd grid (the decayed-weight term on w only): one
    accuracy per combo, each within one test sample of JAX's."""
    from dinov3_tpu.evals.linear import linear_probe_sweep as jax_sweep

    from dinov3_tpu_torch.evals import linear_probe_sweep

    tx, ty = blobs(50, 5, 16, seed=0, spread=0.9)
    vx, vy = blobs(20, 5, 16, seed=1, spread=0.9)
    kw = dict(lrs=(1e-2, 1e-1, 0.5), wds=(0.0, 3e-2), epochs=4, batch_size=64, seed=2)
    want_best, want = jax_sweep(tx, ty, vx, vy, 5, **kw)
    best, got = linear_probe_sweep(tx, ty, vx, vy, 5, **kw,
                                   orders=jax_orders(250, 4, seed=2), device="cpu")
    assert list(got) == list(want) and len(got) == 6
    for key, acc in got.items():
        assert abs(acc - want[key]) <= 1 / len(vy) + 1e-12, (key, acc, want[key])
    assert best == max(got.values()) and abs(best - want_best) <= 1 / len(vy) + 1e-12


def test_sweep_combo_equals_a_lone_probe_at_zero_decay():
    """Port only: at wd = 0 the sweep's combo for an lr trains the weights
    of a lone probe at that lr (within 1e-5) and scores what
    ``linear_probe_eval`` scores; the port's own orders are a permutation
    an epoch, the same for the same seed."""
    from dinov3_tpu_torch.evals import linear_probe_eval, linear_probe_sweep
    from dinov3_tpu_torch.evals.linear import epoch_orders, train_probes

    tx, ty = blobs(50, 5, 16, seed=0, spread=0.9)
    vx, vy = blobs(20, 5, 16, seed=1, spread=0.9)
    kw = dict(epochs=3, batch_size=64, seed=4, device="cpu")
    w, b = train_probes(tx, ty, 5, (1e-2, 1e-1, 0.5), (0.0,) * 3, **kw)
    w1, b1 = train_probes(tx, ty, 5, (1e-1,), (0.0,), decay_bias=True, **kw)
    np.testing.assert_allclose(w[1].numpy(), w1[0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b[1].numpy(), b1[0].numpy(), atol=1e-5, rtol=0)
    _, grid = linear_probe_sweep(tx, ty, vx, vy, 5, lrs=(1e-2, 1e-1, 0.5), **kw)
    assert grid["lr=0.1,wd=0"] == linear_probe_eval(tx, ty, vx, vy, 5, lr=0.1, **kw)
    orders = epoch_orders(250, 3, seed=4)
    assert torch.equal(orders, epoch_orders(250, 3, seed=4))
    assert all(torch.equal(o.sort().values, torch.arange(250)) for o in orders)
    with pytest.raises(ValueError, match="orders"):
        train_probes(tx, ty, 5, (0.1,), (0.0,), orders=orders[:2], **kw)


# ---------------- the harness ----------------

def test_do_eval_matches_jax_do_eval(jax_side):
    """The whole harness on the same synthetic splits and weights (a
    full-batch probe, 32 train rows, so its order does not matter): k-NN
    top-1 equal, linear top-1 within one of the 16 val samples."""
    from dinov3_tpu.evals import do_eval as jax_do_eval

    from dinov3_tpu_torch.evals import do_eval

    jcfg, tcfg, jm, params, tm = models()
    kw = dict(train_dataset_str=SYN_TRAIN, val_dataset_str=SYN_VAL, n_classes=4,
              batch_size=8, max_train_samples=32, max_val_samples=16, probe_epochs=3)
    want = jax_do_eval(jcfg, jm, params, **kw)
    got = do_eval(tcfg, tm, **kw)
    assert set(got) == set(want) == {"knn_top1", "linear_top1"}
    assert got["knn_top1"] == want["knn_top1"]
    assert abs(got["linear_top1"] - want["linear_top1"]) <= 1 / 16 + 1e-12


def test_do_eval_refuses_a_world_and_stops_its_threads_on_a_raise(monkeypatch):
    import dinov3_tpu_torch.evals.harness as H
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.models import build_backbone

    cfg = get_default_config()
    apply_dot_overrides(cfg, EVAL_SMOL)
    model = build_backbone(cfg, device="cpu")
    for kw in (dict(data_world=2), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="M7"):
            H.do_eval(cfg, model, **kw)

    def broken(*args, **kwargs):
        raise RuntimeError("broken extraction")

    monkeypatch.setattr(H, "extract_features", broken)
    with pytest.raises(RuntimeError, match="broken extraction"):
        H.do_eval(cfg, model, train_dataset_str=SYN_TRAIN, batch_size=8)
    # the autouse fixture checks that the loader's producer thread ended


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.evals import knn_classify, linear_probe_eval
    from dinov3_tpu_torch.models import build_model_for_eval

    cfg = get_default_config()
    apply_dot_overrides(cfg, EVAL_SMOL)
    x, y = blobs(4, 2, 8, seed=0, spread=0.1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: build_model_for_eval(cfg),
                 lambda: knn_classify(x, y, x, 2),
                 lambda: linear_probe_eval(x, y, x, y, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    model = build_model_for_eval(cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())


# ---------------- checkpoints, the CLIs and the in-run evals ----------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One trainer CLI run of 2 iterations (a save at 2) in a child
    process, as ``tests/test_torch_trainer.py`` runs it."""
    from test_torch_trainer import run_cli

    d = tmp_path_factory.mktemp("trained")
    run_cli(d, "--max-iterations", 2)
    return d


def trainer_cfg(extra=()):
    from test_torch_trainer import CLI

    from dinov3_tpu_torch.configs import load_config

    return load_config(None, CLI + list(extra), n_devices=1)


def test_build_model_for_eval_loads_the_teacher_of_a_port_checkpoint(trained):
    """The EMA teacher's backbone of the CLI's checkpoint, bitwise; a
    directory with no finalized step raises."""
    from dinov3_tpu_torch.models import build_model_for_eval

    payload = torch.load(trained / "ckpt" / "2" / "state.pt", map_location="cpu",
                         weights_only=True)
    want = {k[len("backbone."):]: v for k, v in payload["teacher"].items()
            if k.startswith("backbone.")}
    model = build_model_for_eval(trainer_cfg(), str(trained / "ckpt"), device="cpu")
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    student = payload["student"]["backbone.blocks.0.attn.qkv.weight"]
    assert not torch.equal(got["blocks.0.attn.qkv.weight"], student)  # the teacher, not the student
    with pytest.raises(FileNotFoundError):
        build_model_for_eval(trainer_cfg(), str(trained / "nowhere"), device="cpu")


def test_build_model_for_eval_loads_a_jax_local_checkpoint(jax_side, tmp_path):
    """A JAX ``TrainState`` saved by the JAX package's local-npz
    checkpointer: the teacher backbone read bitwise (and not the student's);
    an orbax step directory is refused by name."""
    import jax.numpy as jnp

    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from dinov3_tpu.train.train_step import TrainState
    from test_torch_serve import _jax_params

    from dinov3_tpu_torch.interop import state_dict_from_jax
    from dinov3_tpu_torch.models import build_model_for_eval

    _, tcfg, jm, teacher, _ = models()
    student = _jax_params(jm, seed=7)
    state = TrainState({"student": {"backbone": student}, "teacher": {"backbone": teacher}},
                       {}, {}, jnp.asarray(3, jnp.int32))
    ckpt = JaxCheckpointer(str(tmp_path / "jax"), async_save=False)
    try:
        ckpt._local_save(3, state)
    finally:
        ckpt.close()
    model = build_model_for_eval(tcfg, str(tmp_path / "jax"), device="cpu")
    want = state_dict_from_jax(teacher)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    (tmp_path / "orbax" / "5" / "state").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax.*M5"):
        build_model_for_eval(tcfg, str(tmp_path / "orbax"), device="cpu")


def test_serving_model_from_a_checkpoint_serves_the_teachers_features(tmp_path):
    """``load_serving_model(ckpt_dir=...)`` over a saved training state
    serves what the serving model of that state's teacher serves, bit for
    bit."""
    from test_torch_serve import SERVE_SMOL, _drain, _images
    from test_torch_trainer import small_setup

    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.serve import PackedServeEngine, load_serving_model
    from dinov3_tpu_torch.serve import serve_layout_from_cfg

    setup, batch = small_setup()
    state, _ = setup.step_fn(setup.state, batch, setup.scalars(0))
    Checkpointer(tmp_path).save(1, state)
    cfg = trainer_cfg(SERVE_SMOL)
    teacher = {k[len("backbone."):]: v for k, v in state.meta.teacher.state_dict().items()
               if k.startswith("backbone.")}
    with pytest.raises(ValueError, match="not both"):
        load_serving_model(cfg, teacher, ckpt_dir=str(tmp_path), device="cpu")
    out = []
    for model in (load_serving_model(cfg, ckpt_dir=str(tmp_path), device="cpu"),
                  load_serving_model(cfg, teacher, device="cpu")):
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
        out.append(_drain(PackedServeEngine(model, serve_layout_from_cfg(cfg), warn=False),
                          _images()[:4]))
    served, want = out
    assert sorted(served) == sorted(want) == [0, 1, 2, 3]
    for i, w in want.items():
        np.testing.assert_array_equal(served[i].cls_feature, w.cls_feature)
        np.testing.assert_array_equal(served[i].pooled_patch_feature, w.pooled_patch_feature)


EVAL_SETS = [f"evaluation.train_dataset_path={SYN_TRAIN}",
             f"evaluation.val_dataset_path={SYN_VAL}"]


def test_eval_cli_in_a_child_process(trained, tmp_path):
    """``python -m dinov3_tpu_torch.evals --ckpt``: the protocol's JSON
    (k-NN at 10 and 20, the lr sweep), printed as the last line and
    written to ``--output``."""
    from test_torch_trainer import CLI

    out = tmp_path / "eval.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dinov3_tpu_torch.evals", "--ckpt", str(trained / "ckpt"),
         "--batch-size", "8", "--probe-epochs", "2", "--max-train-samples", "32",
         "--max-val-samples", "16", "--output", str(out), *CLI, *EVAL_SETS],
        cwd=REPO, capture_output=True, text=True, timeout=CHILD_TIMEOUT,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"knn10_top1", "knn20_top1", "knn_top1", "linear_top1",
            "linear_sweep"} <= set(results)
    assert len(results["linear_sweep"]) == 8
    assert results["knn_top1"] == max(results["knn10_top1"], results["knn20_top1"])
    assert results["linear_top1"] == max(results["linear_sweep"].values())
    assert all(0.0 <= v <= 1.0 for v in results["linear_sweep"].values())
    assert json.loads(out.read_text()) == results


def test_in_run_evals_record_and_leave_the_losses_bitwise(tmp_path):
    """4 iterations with an eval every 2 against the same run without:
    two ``evals.json`` records (iterations 2 and 4), and the losses of
    every iteration equal bit for bit."""
    import dinov3_tpu_torch.train.train as T

    runs = {}
    frozen = gc.get_freeze_count()
    for name, extra in (("with", ["evaluation.eval_period_iterations=2", *EVAL_SETS]),
                        ("without", [])):
        cfg = trainer_cfg(["MODEL.DEVICE=cpu", *extra])
        cfg.train.output_dir = str(tmp_path / name)
        args = T.get_args_parser().parse_args(
            ["--max-iterations", "4", "--record-losses", str(tmp_path / f"{name}.jsonl")])
        runs[name] = T.do_train(cfg, args)
    assert gc.get_freeze_count() <= frozen  # do_train unfroze what it froze
    records = [json.loads(line) for line in open(tmp_path / "with" / "evals.json")]
    assert [r["iteration"] for r in records] == [2, 4]
    assert all(set(r) == {"iteration", "knn_top1", "linear_top1"} for r in records)
    assert [e["iteration"] for e in runs["with"]["evals"]] == [2, 4]
    assert runs["without"]["evals"] == []
    assert not (tmp_path / "without" / "evals.json").exists()
    want = (tmp_path / "without.jsonl").read_text().splitlines()
    got = (tmp_path / "with.jsonl").read_text().splitlines()
    assert len(got) == 4 and got == want


# ---------------- on the card ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_eval_shape_kernels_match_plain(cuda_device):
    """K1 at the eval shape ([256 x 16, 197, 64] bf16, no segment ids) and
    K4 at [256 x 197, 1024] bf16: one launch each, within the bf16
    tolerances of ``tests/test_torch_kernels.py`` of their plain versions."""
    from dinov3_tpu_torch.ops.flash_attention import FLASH_FWD, attention_plain, flash_attention
    from dinov3_tpu_torch.ops.fused_norm import LAYERNORM_FWD, fused_layernorm, layernorm_plain

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(256, 197, 16, 64, generator=g).to(cuda_device, torch.bfloat16)
               for _ in range(3))
    before = FLASH_FWD.launches
    out, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_FWD.launches == before + 1
    want, want_lse = attention_plain(q, k, v)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    assert (lse - want_lse).abs().max().item() <= 2e-1
    x = (torch.randn(256 * 197, 1024, generator=g) * 3 + 1).to(cuda_device, torch.bfloat16)
    s = (torch.randn(1024, generator=g) * 0.5 + 1).to(cuda_device)
    b = torch.randn(1024, generator=g).to(cuda_device)
    before = LAYERNORM_FWD.launches
    y = fused_layernorm(x, s, b)
    torch.cuda.synchronize()
    assert LAYERNORM_FWD.launches == before + 1
    ref = layernorm_plain(x, s, b).float()
    assert (y.float() - ref).abs().max().item() <= 2.0 ** -7 * max(ref.abs().max().item(), 1.0)
