"""The port's tar-backed datasets, crop-size lists and the dataset adapter
(``dinov3_tpu_torch/data``) against the JAX package's, on shards and
class tarballs each test writes under ``tmp_path``, on the CPU.

Both sides read the same bytes with the same numpy and PIL code, so
every comparison is exact: indices, order, labels, image bytes, decoded
samples, the combiner's choice stream and whole training batches. The
JAX side's host C++ helpers run on their numpy paths (as in
``tests/test_torch_data.py``).
"""

import io
import itertools
import json
import os
import tarfile

import numpy as np
import pytest

from test_torch_data import B, assert_same, cfgs, numpy_paths, take  # noqa: F401
from test_torch_train import SMOL


def _jpeg(rng, px=40) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (px, px + 8, 3), dtype=np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def _add(tf, name: str, payload: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(payload)
    tf.addfile(info, io.BytesIO(payload))


def write_shards(root, n_shards=3, per_shard=5, seed=0) -> str:
    """``shard-%06d.tar`` files of ``<key>.jpg`` / ``<key>.cls`` pairs,
    members in a shuffled order, one key a shard without a label, and a
    directory member and a stray text member that are not samples."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(n_shards):
        with tarfile.open(os.path.join(root, f"shard-{s:06d}.tar"), "w") as tf:
            d = tarfile.TarInfo("meta")
            d.type = tarfile.DIRTYPE
            tf.addfile(d)
            members = []
            for i in rng.permutation(per_shard):
                key = f"{s:03d}{i:04d}"
                members.append((f"{key}.jpg", _jpeg(rng)))
                if i != per_shard - 1:
                    members.append((f"{key}.cls", str(int(rng.integers(0, 7))).encode()))
            members.append(("notes.txt", b"not a sample"))
            for name, payload in members:
                _add(tf, name, payload)
    return str(root)


def write_class_tars(root, n_classes=3, per_class=4, seed=1) -> str:
    """ImageNet-22k's layout: one ``<wnid>.tar`` of JPEGs a class."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for c in range(n_classes):
        with tarfile.open(os.path.join(root, f"n{c:08d}.tar"), "w") as tf:
            for i in range(per_class):
                _add(tf, f"n{c:08d}_{i}.JPEG", _jpeg(rng, px=32))
    return str(root)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("shards"))


def _same_dataset(got, want):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.get_targets(), want.get_targets())
    for i in range(len(want)):
        assert got.get_image_data(i) == want.get_image_data(i), i
        assert got.get_target(i) == want.get_target(i), i
        (gi, gt), (wi, wt) = got[i], want[i]
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        assert gt == wt


def test_web_shards_index_order_and_labels_match_jax(shards, tmp_path, monkeypatch):
    """Index, order (by shard, then key), labels (-1 without ``.cls``),
    bytes and decoded samples equal JAX ``WebShards``'s; the index cache
    beside each shard is written and read back; a split without its own
    shard directory is refused on both sides."""
    from dinov3_tpu.data.datasets import WebShards as JaxWebShards

    from dinov3_tpu_torch.data.datasets import WebShards
    from dinov3_tpu_torch.data.datasets import web_shards as port_ws

    got = WebShards(root=shards, seed=3)
    want = JaxWebShards(root=shards, seed=3)
    assert len(got) == 15 and got.shards == want.shards
    np.testing.assert_array_equal(got._entries, want._entries)
    assert (got.get_targets() == -1).sum() == 3
    _same_dataset(got, want)
    assert all(os.path.exists(s + ".idx.npy") for s in got.shards)

    def no_scan(path):
        raise AssertionError("the cached index was not used")

    monkeypatch.setattr(port_ws, "_index_shard", no_scan)
    np.testing.assert_array_equal(WebShards(root=shards)._entries, want._entries)
    monkeypatch.undo()
    for cls in (WebShards, JaxWebShards):
        with pytest.raises(FileNotFoundError):
            cls(root=shards, split="VAL")
    val = write_shards(tmp_path / "lvd" / "val", n_shards=1, per_shard=3, seed=5)
    write_shards(tmp_path / "lvd", n_shards=2, per_shard=2, seed=6)
    _same_dataset(WebShards(root=str(tmp_path / "lvd"), split="VAL"),
                  JaxWebShards(root=str(tmp_path / "lvd"), split="VAL"))
    assert WebShards(root=str(tmp_path / "lvd"), split="VAL").shards[0].startswith(val)


def test_image_net_22k_matches_jax(tmp_path):
    """Entries (class, tar, offset, size) in member order, the cached
    tables under ``extra/``, bytes, targets and samples equal JAX
    ``ImageNet22k``'s, the index built once and read by the other side."""
    from dinov3_tpu.data.datasets import ImageNet22k as JaxImageNet22k

    from dinov3_tpu_torch.data.datasets import ImageNet22k

    root = write_class_tars(tmp_path / "in22k")
    got = ImageNet22k(root=root, seed=2)
    assert len(got) == 12 and sorted(os.listdir(os.path.join(root, "extra"))) == [
        "entries-ALL.npy", "tar-names-ALL.npy"]
    want = JaxImageNet22k(root=root, seed=2)  # reads the port's cached tables
    fresh = JaxImageNet22k(root=root, extra=str(tmp_path / "jax_extra"), seed=2)
    np.testing.assert_array_equal(got._get_entries(), fresh._get_entries())
    np.testing.assert_array_equal(got.get_targets(), np.repeat(np.arange(3), 4))
    _same_dataset(got, want)
    with pytest.raises(FileNotFoundError):
        len(ImageNet22k(root=str(tmp_path / "empty_dir_missing")))


def test_tar_mmap_cache_reads_slices_and_evicts(shards):
    from dinov3_tpu.data.datasets.tar_backed import TarMmapCache as JaxCache

    from dinov3_tpu_torch.data.datasets import TarMmapCache, WebShards

    ds = WebShards(root=shards)
    got = TarMmapCache(lambda i: ds.shards[i], cache_size=1)
    want = JaxCache(lambda i: ds.shards[i], cache_size=1)
    for row in list(ds._entries) * 2:  # alternating shards evict each other
        args = (row["shard"], row["offset"], row["size"])
        assert got.read(*args) == want.read(*args)


def test_enumerated_targets_adapter_matches_jax(shards):
    from dinov3_tpu.data.adapters import DatasetWithEnumeratedTargets as JaxAdapter

    from dinov3_tpu_torch.data import DatasetWithEnumeratedTargets
    from dinov3_tpu_torch.data.datasets import WebShards

    ds = WebShards(root=shards)
    for pad, replicas in ((False, 1), (True, 4), (True, 1)):
        got = DatasetWithEnumeratedTargets(ds, pad_dataset=pad, num_replicas=replicas)
        want = JaxAdapter(ds, pad_dataset=pad, num_replicas=replicas)
        assert len(got) == len(want) == (16 if pad and replicas == 4 else 15)
        for i in range(len(want)):
            assert got.get_target(i) == want.get_target(i)
            assert got[i][1] == want[i][1]
            np.testing.assert_array_equal(np.asarray(got[i][0]), np.asarray(want[i][0]))


# ---------------- crop-size lists ----------------

@pytest.mark.parametrize("ratios", [[1.0, 1.0], [0.2, 0.5, 0.3], [3.0, 1.0]])
def test_split_advance_and_the_combiner_stream_are_bitwise_jax(ratios):
    """The choice stream over tagged infinite loaders, its replayed counts
    and a resume by ``advance`` equal the JAX combiner's, draw for draw."""
    from dinov3_tpu.data.multires import CombineDataLoader as JaxCombine
    from dinov3_tpu.data.multires import split_advance as jax_split

    from dinov3_tpu_torch.data import CombineDataLoader, split_advance

    def loaders():
        return [((k, i) for i in itertools.count()) for k in range(len(ratios))]

    for seed in (0, 7):
        for n in (0, 1, 13, 40):
            np.testing.assert_array_equal(split_advance(seed, ratios, n),
                                          jax_split(seed, ratios, n))
        want = list(itertools.islice(iter(JaxCombine(loaders(), ratios, seed)), 60))
        got = list(itertools.islice(iter(CombineDataLoader(loaders(), ratios, seed)), 60))
        assert got == want
        counts = split_advance(seed, ratios, 25)
        resumed = CombineDataLoader(
            [((k, i) for i in itertools.count(int(counts[k]))) for k in range(len(ratios))],
            ratios, seed)
        resumed.advance(25)
        assert list(itertools.islice(iter(resumed), 35)) == want[25:]


def test_multires_subconfigs_match_jax_and_gram_lists_wait():
    from dinov3_tpu.data.multires import multires_subconfigs as jax_subs

    from dinov3_tpu_torch.data import multires_subconfigs

    lists = ["crops.global_crops_size=[16,24]", "crops.local_crops_size=[8,12]",
             "crops.global_local_crop_pairs_ratios=[0.25,0.75]"]
    jcfg, tcfg = cfgs(lists)
    got, want = multires_subconfigs(tcfg), jax_subs(jcfg)
    assert [(c.crops.global_crops_size, c.crops.local_crops_size, r) for c, r in got] == [
        (c.crops.global_crops_size, c.crops.local_crops_size, r) for c, r in want]
    assert multires_subconfigs(cfgs()[1]) is None and jax_subs(cfgs()[0]) is None
    _, gram = cfgs(lists + ["crops.gram_teacher_crops_size=[32,48]"])
    with pytest.raises(NotImplementedError, match="M12"):
        multires_subconfigs(gram)


# ---------------- the trainer's pipeline on web shards ----------------

def shard_cfgs(root, extra=()):
    return cfgs(["data.backend=imagenet", "train.dataset_path=WebShards:split=TRAIN",
                 f"data.root={root}", "train.num_workers=3", *extra])


def test_web_shard_pipeline_matches_jax_and_resumes(numpy_paths, shards):  # noqa: F811
    """``WebShards:`` batches through the trainer's pipeline equal the JAX
    pipeline's; so do a two-resolution list's batches
    (``make_multires_train_pipeline``), and a list resumed 3 batches in
    continues the uninterrupted stream."""
    from dinov3_tpu.data.pipeline import make_multires_train_pipeline as jax_multires
    from dinov3_tpu.data.pipeline import make_train_pipeline as jax_pipeline

    from dinov3_tpu_torch.data.pipeline import (
        make_multires_train_pipeline,
        make_train_pipeline,
    )

    jcfg, tcfg = shard_cfgs(shards)
    assert_same(take(make_train_pipeline(tcfg, B), 3), take(jax_pipeline(jcfg, B), 3))
    jcfg, tcfg = shard_cfgs(shards, ["crops.global_crops_size=[16,24]",
                                     "crops.local_crops_size=[8,8]"])
    want = take(jax_multires(jcfg, B), 6)
    got = take(make_multires_train_pipeline(tcfg, B), 6)
    assert_same(got, want)
    assert {b["global_crops"].shape[1] for b in got} == {16, 24}
    assert_same(take(make_multires_train_pipeline(tcfg, B, sampler_advance_batches=3), 3),
                got[3:])


def test_trainer_reads_web_shards_and_resumes(numpy_paths, shards, tmp_path):  # noqa: F811
    """The trainer with ``data.backend=imagenet`` on ``WebShards:`` strings
    (the ViT-g/14 recipe's): 3 iterations against 2, then a resume to 3
    whose iteration-2 losses are the uninterrupted run's, bit for bit."""
    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.configs import load_config

    def run(out, iters):
        cfg = load_config(None, ["MODEL.DEVICE=cpu", *SMOL,
                                 f"train.batch_size_per_device={B}",
                                 "checkpointing.period=2", "data.backend=imagenet",
                                 "train.dataset_path=WebShards:split=TRAIN",
                                 f"data.root={shards}", "train.num_workers=3"], n_devices=1)
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


def test_vitg14_recipe_runs_from_web_shards_through_the_cli(shards, tmp_path):
    """``configs/train/vitg14_webshards.yaml`` through ``python -m
    dinov3_tpu_torch.train.train`` on the CPU, cut to ``vit_test`` width
    with small heads and crops (the recipe's SwiGLU, patch 14, 4
    registers, masked k bias, block remat and drop path 0.4 kept), with the
    one-card override ``parallel.fsdp=1``: it runs, saves, and a second
    process resumes from the save; the recipe's ``parallel.fsdp=8`` is
    refused by name."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    small = ["MODEL.DEVICE=cpu", "parallel.fsdp=1", f"data.root={shards}",
             "student.arch=vit_test", "train.batch_size_per_device=2",
             "crops.global_crops_size=42", "crops.local_crops_size=14",
             "dino.head_n_prototypes=64", "dino.head_hidden_dim=24",
             "dino.head_bottleneck_dim=8", "ibot.head_n_prototypes=64",
             "ibot.head_hidden_dim=24", "ibot.head_bottleneck_dim=8",
             "train.num_workers=2", "checkpointing.period=2"]

    def run(iters, *extra, rc=0):
        proc = subprocess.run(
            [sys.executable, "-m", "dinov3_tpu_torch.train.train", "--config-file",
             "configs/train/vitg14_webshards.yaml", "--output-dir", str(tmp_path / "run"),
             "--max-iterations", str(iters), *small, *extra],
            cwd=repo, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
        assert proc.returncode == rc, proc.stdout[-3000:] + proc.stderr[-3000:]
        return proc

    first = json.loads(run(2).stdout.strip().splitlines()[-1])
    assert (first["remat"], first["crop_packing"], first["scan_layers"]) == (
        "blocks", True, True)
    assert [s["step"] for s in first["saves"]] == [2] and np.isfinite(first["final_loss"])
    second = json.loads(run(3).stdout.strip().splitlines()[-1])
    assert second["start_iteration"] == 2 and second["iterations"] == 3
    assert np.isfinite(second["final_loss"])
    refused = run(1, "parallel.fsdp=8", rc=1)
    assert "parallel.fsdp=8" in refused.stderr and "M7" in refused.stderr
