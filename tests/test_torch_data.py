"""The port's image-folder pipeline (``dinov3_tpu_torch/data``) against the
JAX package's on the same texture images, sampler state and seeds, on the
CPU at small sizes.

Both sides run numpy and PIL on the same bytes, so every comparison is
bitwise: the JAX side with its host C++ helpers (``dinov3_tpu/native``:
colour jitter, normalization, crop stacking) switched to its own numpy
paths, which the port copies (the C++ ones agree with them within fp32
rounding, ``tests/test_native.py``).
"""

import threading
from pathlib import Path

import numpy as np
import pytest

from test_torch_train import SMOL

B = 4


@pytest.fixture
def numpy_paths(monkeypatch):
    """The JAX package's host helpers on their numpy paths."""
    from dinov3_tpu import native

    for name in ("normalize_image", "stack_crops", "color_jitter"):
        monkeypatch.setattr(native, name, lambda *a, **k: None)


@pytest.fixture(scope="module")
def textures(tmp_path_factory):
    """Texture class folders written by the port (12 classes x 2 images of
    40 px)."""
    from dinov3_tpu_torch.data.textures import materialize_textures

    root = tmp_path_factory.mktemp("textures")
    train, _ = materialize_textures(str(root), n_train_per_class=2,
                                    n_val_per_class=1, px=40, seed=3)
    return root, train


def cfgs(extra=()):
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config

    from dinov3_tpu_torch.configs import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs import get_default_config as t_default

    jcfg, tcfg = get_default_config(), t_default()
    apply_dot_overrides(jcfg, SMOL + list(extra))
    t_apply(tcfg, SMOL + list(extra))
    return jcfg, tcfg


def assert_same(a, b, where=""):
    """Equal nested dicts/lists/tuples of arrays and scalars, arrays with
    equal dtypes, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_textures_are_the_jax_textures(textures, tmp_path):
    from dinov3_tpu.data.textures import materialize_textures as jax_textures

    root, _ = textures
    jax_textures(str(tmp_path), n_train_per_class=2, n_val_per_class=1, px=40, seed=3)
    ours = sorted(p.relative_to(root) for p in root.rglob("*.png"))
    theirs = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*.png"))
    assert ours == theirs and len(ours) == 36
    for rel in ours:
        assert (root / rel).read_bytes() == (tmp_path / rel).read_bytes(), rel


@pytest.mark.parametrize("extra", [
    [],
    ["crops.localcrops_subset_of_globalcrops=true", "crops.share_color_jitter=true"],
    ["train.teacher_no_color_jitter=true", "crops.gram_teacher_crops_size=24",
     "crops.gram_teacher_no_distortions=true", "crops.horizontal_flips=false"],
], ids=["default", "local-subset-shared-jitter", "teacher-undistorted-gram"])
def test_dino_augmentation_matches_jax(numpy_paths, textures, extra):
    from PIL import Image

    from dinov3_tpu.data.augmentations import build_augmentation_from_cfg as jax_aug

    from dinov3_tpu_torch.data.augmentations import build_augmentation_from_cfg

    _, train = textures
    jcfg, tcfg = cfgs(extra)
    jaug, taug = jax_aug(jcfg), build_augmentation_from_cfg(tcfg)
    paths = sorted(Path(train).rglob("*.png"))[:5]
    for i, path in enumerate(paths):
        image = Image.open(path).convert("RGB")
        want = jaug(np.random.default_rng((7, i)), image)
        got = taug(np.random.default_rng((7, i)), image)
        assert_same(got, want, f"image {i}")
        assert got["global_crops"][0].dtype == np.float32


def test_collate_matches_jax(numpy_paths):
    from dinov3_tpu.data.collate import collate_crops as jax_collate

    from dinov3_tpu_torch.data.collate import collate_crops

    rng = np.random.default_rng(0)
    samples = [{"global_crops": [rng.standard_normal((16, 16, 3)).astype(np.float32)
                                 for _ in range(2)],
                "local_crops": [rng.standard_normal((8, 8, 3)).astype(np.float32)
                                for _ in range(3)],
                "offsets": [(0, 4), (4, 0), (4, 4)], "label": i}
               for i in range(B)]
    for s in samples:
        s["global_crops_teacher"] = s["global_crops"]
    kw = dict(patch_size=4, global_crops_size=16, mask_ratio_min_max=(0.1, 0.5),
              mask_probability=0.5)
    for shift in (False, True):
        want = jax_collate(samples, np.random.default_rng(1),
                           mask_random_circular_shift=shift, **kw)
        got = collate_crops(samples, np.random.default_rng(1),
                            mask_random_circular_shift=shift, **kw)
        assert_same(got, want)
        assert got["global_crops"].shape == (2 * B, 16, 16, 3)
        assert "global_crops_teacher" not in got  # the same crops: not stacked twice


@pytest.mark.parametrize("kind", ["EpochSampler", "InfiniteSampler",
                                  "ShardedInfiniteSampler"])
def test_samplers_match_jax_and_resume(kind):
    import itertools

    import dinov3_tpu.data.samplers as jax_samplers

    import dinov3_tpu_torch.data.samplers as samplers

    for rank, world in ((0, 1), (1, 3)):
        kw = dict(size=11, rank=rank, world_size=world, shuffle=True, seed=5)
        want = list(itertools.islice(iter(getattr(jax_samplers, kind)(**kw)), 40))
        got = list(itertools.islice(iter(getattr(samplers, kind)(**kw)), 40))
        assert got == want
        resumed = getattr(samplers, kind)(**kw)
        resumed.advance(7)
        jax_resumed = getattr(jax_samplers, kind)(**kw)
        jax_resumed.advance(7)
        tail = list(itertools.islice(iter(resumed), 20))
        assert tail == list(itertools.islice(iter(jax_resumed), 20))
        if kind != "EpochSampler":  # EpochSampler advances by global samples
            assert tail == got[7:27]


def folder_cfgs(train_dir, extra=()):
    return cfgs(["data.backend=folder", f"train.dataset_path=Folder:root={train_dir}",
                 "train.num_workers=3", "data.prefetch=2", *extra])


def take(iterator, n):
    try:
        return [next(iterator) for _ in range(n)]
    finally:
        iterator.close()


def test_train_pipeline_matches_jax_and_resumes(numpy_paths, textures):
    """The first batches of the port's folder pipeline equal the JAX
    pipeline's; started 2 batches in (``sampler_advance``), both the
    samples and the iBOT mask stream (``_SeededCollate``) pick up where the
    uninterrupted stream was."""
    from dinov3_tpu.data.pipeline import make_train_pipeline as jax_pipeline

    from dinov3_tpu_torch.data.pipeline import make_train_pipeline

    _, train = textures
    jcfg, tcfg = folder_cfgs(train)
    want = take(jax_pipeline(jcfg, B), 4)
    got = take(make_train_pipeline(tcfg, B), 4)
    assert_same(got, want)
    assert got[0]["global_crops"].shape == (2 * B, 16, 16, 3)
    assert got[0]["local_crops"].shape == (2 * B, 8, 8, 3)
    resumed = take(make_train_pipeline(tcfg, B, sampler_advance=2 * B), 2)
    assert_same(resumed, got[2:])
    jax_resumed = take(jax_pipeline(jcfg, B, sampler_advance=2 * B), 2)
    assert_same(jax_resumed, want[2:])


def test_loader_stops_its_threads_when_closed(textures):
    from dinov3_tpu_torch.data.loaders import BackgroundIterator
    from dinov3_tpu_torch.data.pipeline import make_train_pipeline

    _, train = textures
    it = make_train_pipeline(folder_cfgs(train)[1], B)
    next(it)
    assert it.alive
    it.close()
    assert not it.alive
    with pytest.raises(StopIteration):
        next(it)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    gen = endless()
    bg = BackgroundIterator(gen, depth=2, transform=lambda x: x * 2)
    assert [next(bg) for _ in range(5)] == [0, 2, 4, 6, 8]
    bg.close()
    assert not bg.alive and gen.gi_frame is None  # the source was closed too
    assert not any(t.name == "dinov3-data-producer" and t.is_alive()
                   for t in threading.enumerate())


def test_background_iterator_hands_over_errors_and_ends():
    from dinov3_tpu_torch.data.loaders import BackgroundIterator

    def failing():
        yield 1
        raise ValueError("broken sample")

    bg = BackgroundIterator(failing())
    assert next(bg) == 1
    with pytest.raises(ValueError, match="broken sample"):
        next(bg)
    assert not bg.alive
    assert list(BackgroundIterator(iter(range(3)))) == [0, 1, 2]


def test_only_the_folder_dataset_is_ported():
    """The trainer's pipeline takes every ported dataset string (a missing
    tree is a missing file, not a refusal); the datasets the port lacks
    are refused by name."""
    from dinov3_tpu_torch.data.loaders import make_dataset
    from dinov3_tpu_torch.data.pipeline import make_train_pipeline

    for name in ("ImageNet:split=TRAIN", "ImageNet22k", "WebShards:split=TRAIN"):
        _, tcfg = cfgs(["data.root=/nowhere", f"train.dataset_path={name}"])
        with pytest.raises(FileNotFoundError):
            make_train_pipeline(tcfg, B)
        with pytest.raises(FileNotFoundError):
            len(make_dataset(f"{name}:root=/nowhere"))
    for name in ("ADE20K", "CocoCaptions"):
        with pytest.raises(NotImplementedError, match="ROADMAP M12"):
            make_dataset(f"{name}:split=TRAIN:root=/nowhere")


def test_folder_run_resumes_its_data_stream(numpy_paths, textures, tmp_path):
    """``data.backend=folder`` through the trainer in this process: 3
    iterations against 2, then a resume to 3 whose iteration-2 losses are
    the uninterrupted run's, bit for bit (the sampler and mask stream
    advanced to the checkpoint)."""
    import json

    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.configs import load_config

    _, train = textures

    def run(out, iters):
        cfg = load_config(None, ["MODEL.DEVICE=cpu", *SMOL, f"train.batch_size_per_device={B}",
                                 "checkpointing.period=2", "data.backend=folder",
                                 f"train.dataset_path=Folder:root={train}",
                                 "train.num_workers=3"], n_devices=1)
        cfg.train.output_dir = str(out)
        args = T.get_args_parser().parse_args(
            ["--max-iterations", str(iters), "--record-losses", str(out / f"{iters}.jsonl")])
        return T.do_train(cfg, args)

    whole = run(tmp_path / "a", 3)
    assert run(tmp_path / "r", 2)["iterations"] == 2
    resumed = run(tmp_path / "r", 3)
    assert whole["start_iteration"] == 0 and resumed["start_iteration"] == 2

    def rows(path):
        return {r["iteration"]: r for r in map(json.loads, open(path))}

    want, got = rows(tmp_path / "a" / "3.jsonl"), rows(tmp_path / "r" / "3.jsonl")
    assert sorted(got) == [2] and got[2] == want[2]
    assert all(np.isfinite(v) for v in want[2].values())
