"""The port's trainer loop and checkpoints (``dinov3_tpu_torch/train/train.py``,
``checkpoint.py``) on the CPU at ``vit_test`` size (the ``SMOL`` overrides
of ``tests/test_torch_train.py``, drop path 0.3).

Every run of the CLI's ``main`` is a child process
(``python -m dinov3_tpu_torch.train.train``, ``MODEL.DEVICE=cpu``, a time
limit): ``main`` seeds the process's ``random`` and ``np.random``. Tests
that drive ``do_train`` in this process leave the collector, the loggers
and the data threads as they found them, and check that they did.

Tolerances:
- resume of the port's own runs, across processes: bitwise (losses,
  student, teacher, Adam moments, count);
- the JAX checkpoint bridge: the restored state bitwise equal to the JAX
  state; the two steps after it, loss terms 1e-4 relative, the teacher
  within the bound of ``test_three_fp32_steps_match_jax_make_train_step``
  summed over the steps taken apart;
- ``--ref-losses``: the comparator's own 1e-4 + 1e-3 relative.
"""

import contextlib
import gc
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported here, at collection: importing orbax (which the JAX package's
# checkpoint module does) puts the interpreter's 375 start-up objects
# back into the collector's permanent generation, which
# ``_process_state_unchanged`` would blame on whichever test imported it
# first after a ``do_train`` had unfrozen them
import dinov3_tpu.checkpoint  # noqa: F401
from test_torch_train import LOSSES, SMOL, _jax_plan, _np, cfgs

REPO = Path(__file__).resolve().parent.parent
B = 4
CLI = ["MODEL.DEVICE=cpu", *SMOL, f"train.batch_size_per_device={B}",
       "checkpointing.period=2"]
CLI_TIMEOUT = 300
# the intra-op thread count of the CLI's child processes: CPU reductions
# split their work by it, so losses agree bitwise only between runs made
# with the same count
CLI_THREADS = 2


@pytest.fixture(autouse=True)
def _no_ambient_mesh():
    """The JAX side reads the process's current mesh; these single-device
    comparisons run without one (as in ``tests/test_torch_train.py``)."""
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh

    prev = get_current_mesh()
    set_current_mesh(None)
    yield
    set_current_mesh(prev)


@pytest.fixture(autouse=True)
def _process_state_unchanged():
    """Whatever a test drives in this process, the collector (enabled as
    it was, its callbacks as they were, nothing left frozen beyond what
    was: ``do_train`` unfreezes what its ``gc.freeze()`` froze), the
    port's logger and the data producer threads end as they began."""
    from dinov3_tpu_torch.logging_utils import LOGGER_NAME

    log = logging.getLogger(LOGGER_NAME)
    before = (gc.isenabled(), list(gc.callbacks), list(log.handlers))
    # a full collection moves the interpreter's immortal start-up objects
    # (375 here) into the permanent generation, from which an earlier
    # test's ``do_train`` unfroze them: count them in before the test, so
    # that a full collection inside it is not taken for a freeze
    gc.collect()
    frozen = gc.get_freeze_count()
    yield
    for t in threading.enumerate():
        if t.name == "dinov3-data-producer":
            t.join(10)
    assert not any(t.name == "dinov3-data-producer" and t.is_alive()
                   for t in threading.enumerate()), "a data producer thread outlived its test"
    assert (gc.isenabled(), list(gc.callbacks), list(log.handlers)) == before
    assert gc.get_freeze_count() <= frozen


def run_cli(out_dir, *args, expect_rc=0, extra=()) -> dict:
    """``python -m dinov3_tpu_torch.train.train`` in a child process (the
    ``CLI`` overrides, then ``extra``); its result is the last line of its
    output."""
    env = dict(os.environ, OMP_NUM_THREADS=str(CLI_THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "dinov3_tpu_torch.train.train",
         "--output-dir", str(out_dir), *map(str, args), *CLI, *extra],
        cwd=REPO, capture_output=True, text=True, timeout=CLI_TIMEOUT, env=env)
    assert proc.returncode == expect_rc, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def cli_threads():
    """Run this process's CPU ops with ``run_cli``'s thread count, then
    restore the count: an in-process run compared against a child's
    recorded losses reduces in the same order."""
    n = torch.get_num_threads()
    torch.set_num_threads(CLI_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def port_cfg(out_dir, extra=()):
    from dinov3_tpu_torch.configs import load_config

    cfg = load_config(None, CLI + list(extra), n_devices=1)
    cfg.train.output_dir = str(out_dir)
    return cfg


def port_args(*argv):
    from dinov3_tpu_torch.train.train import get_args_parser

    return get_args_parser().parse_args(list(map(str, argv)))


def read_losses(path) -> dict:
    with open(path) as f:
        return {r.pop("iteration"): r for r in map(json.loads, f)}


def load_ckpt(run_dir, step) -> dict:
    return torch.load(Path(run_dir) / "ckpt" / str(step) / "state.pt",
                      map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """One CLI run of 4 iterations, saving every 2, its losses recorded."""
    d = tmp_path_factory.mktemp("cli")
    result = run_cli(d / "a", "--max-iterations", 4, "--record-losses", d / "a.jsonl")
    return d, result


def small_setup(seed=3):
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    tcfg = cfgs()[1]
    batch = make_synthetic_batch(tcfg, B, seed=1)
    return build_train_setup(tcfg, batch, device="cpu", seed=seed), batch


# ---------------- resume across processes ----------------

def plant_torn_saves(ckpt_dir: Path) -> None:
    """What a save cut at each point leaves, all newer than step 2: a
    ``tmp.3/`` (cut before its rename), a ``3/`` without ``FINALIZED`` (cut
    before its marker, as an older layout would leave it), and a ``4/``
    whose marker vouches for more bytes than its payload holds."""
    payload = (ckpt_dir / "2" / "state.pt").read_bytes()
    for name, marker in (("tmp.3", {"step": 3, "bytes": len(payload)}), ("3", None),
                         ("4", {"step": 4, "bytes": len(payload)})):
        (ckpt_dir / name).mkdir()
        (ckpt_dir / name / "state.pt").write_bytes(payload[: len(payload) // 2])
        if marker is not None:
            (ckpt_dir / name / "FINALIZED").write_text(json.dumps(marker))


def test_cli_resumes_in_a_new_process_bitwise_past_torn_saves(uninterrupted):
    """4 iterations in one process against 2, then a new process resuming
    to 4 past the planted torn saves: the same losses and the same final
    student, teacher, moments and count, bit for bit."""
    d, a = uninterrupted
    r = d / "r"
    first = run_cli(r, "--max-iterations", 2, "--record-losses", d / "r1.jsonl")
    assert first["start_iteration"] == 0 and first["iterations"] == 2
    plant_torn_saves(r / "ckpt")
    second = run_cli(r, "--max-iterations", 4, "--record-losses", d / "r2.jsonl")
    assert second["start_iteration"] == 2 and second["iterations"] == 4
    assert a["start_iteration"] == 0 and a["iterations"] == 4
    want = read_losses(d / "a.jsonl")
    got = {**read_losses(d / "r1.jsonl"), **read_losses(d / "r2.jsonl")}
    assert sorted(got) == [0, 1, 2, 3] and got == want
    assert all(math.isfinite(v) for row in got.values() for v in row.values())
    wa, wr = load_ckpt(d / "a", 4), load_ckpt(r, 4)
    assert (wa["count"], wa["step"]) == (wr["count"], wr["step"]) == (4, 4)
    for key in ("student", "teacher", "mu", "nu"):
        assert wa[key].keys() == wr[key].keys()
        for n in wa[key]:
            assert torch.equal(wa[key][n], wr[key][n]), (key, n)
    assert sorted(os.listdir(r / "ckpt")) == ["2", "3", "4", "tmp.3"]


# the recipe's options on top of the tiny model: streaming targets,
# softmax centering, two microbatches a step and block remat
RECIPE_OPTIONS = ("loss.streaming_targets=true", "loss.k_tile=24",
                  "train.centering=softmax_center", "optim.accum_steps=2",
                  "train.checkpointing=true")


def test_cli_resumes_bitwise_under_softmax_centering_accum_and_remat(tmp_path):
    """As the test above, under ``RECIPE_OPTIONS``: 4 iterations in one
    process against 2 then a resume to 4 in a new process; losses, the
    centers and the final student, teacher and moments equal bit for
    bit, and the centers moved."""
    opts = dict(extra=RECIPE_OPTIONS)
    a = run_cli(tmp_path / "a", "--max-iterations", 4,
                "--record-losses", tmp_path / "a.jsonl", **opts)
    assert (a["targets"], a["centering"], a["remat"], a["accum_steps"]) == (
        "streaming", "softmax_center", "blocks", 2)
    r = tmp_path / "r"
    run_cli(r, "--max-iterations", 2, "--record-losses", tmp_path / "r1.jsonl", **opts)
    second = run_cli(r, "--max-iterations", 4, "--record-losses", tmp_path / "r2.jsonl",
                     **opts)
    assert second["start_iteration"] == 2 and second["iterations"] == 4
    want = read_losses(tmp_path / "a.jsonl")
    got = {**read_losses(tmp_path / "r1.jsonl"), **read_losses(tmp_path / "r2.jsonl")}
    assert sorted(got) == [0, 1, 2, 3] and got == want
    wa, wr = load_ckpt(tmp_path / "a", 4), load_ckpt(r, 4)
    for key in ("student", "teacher", "mu", "nu", "center_state"):
        assert wa[key].keys() == wr[key].keys()
        for n in wa[key]:
            assert torch.equal(wa[key][n], wr[key][n]), (key, n)
    assert all(wa["center_state"][k].abs().sum() > 0 for k in wa["center_state"])


def test_cli_self_check_passes_and_exits_zero(tmp_path):
    result = run_cli(tmp_path, "--self-check")
    checks = {k: v for k, v in result.items() if k.startswith("check/")}
    assert result["self_check_failures"] == 0 and all(checks.values())
    assert len(checks) == 5 + 3 + 3 + 1  # losses, student, teacher, counter


def test_trainer_imports_no_pil_and_no_jax():
    code = ("import sys, dinov3_tpu_torch.train.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dinov3_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------- checkpoints ----------------

def test_checkpoint_round_trip_is_bitwise(tmp_path):
    from dinov3_tpu_torch.checkpoint import Checkpointer

    setup, batch = small_setup(seed=3)
    state, _ = setup.step_fn(setup.state, batch, setup.scalars(0))
    ckpt = Checkpointer(tmp_path)
    info = ckpt.save(1, state)
    assert info["step"] == 1 and info["bytes"] == os.path.getsize(tmp_path / "1" / "state.pt")
    other, _ = small_setup(seed=4)
    restored = ckpt.restore(other.state)
    assert restored.step == 1 and restored.opt_state.count == 1
    for role in ("student", "teacher"):
        want = getattr(state.meta, role).state_dict()
        for n, t in getattr(restored.meta, role).state_dict().items():
            assert torch.equal(t, want[n]), (role, n)
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    restored.opt_state.mu + restored.opt_state.nu):
        assert torch.equal(a, b)


def test_centers_survive_save_and_restore(tmp_path):
    """Softmax centering: the centers after a step are saved and restored
    bit for bit; a payload without centers is refused under softmax
    centering and keeps the initial ones under Sinkhorn-Knopp."""
    from dinov3_tpu_torch.checkpoint import Checkpointer, load_payload, state_payload
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    tcfg = cfgs(["train.centering=softmax_center"])[1]
    batch = make_synthetic_batch(tcfg, B, seed=1)
    setup = build_train_setup(tcfg, batch, device="cpu", seed=3)
    state, _ = setup.step_fn(setup.state, batch, setup.scalars(0))
    assert all(c.abs().sum() > 0 for c in state.center_state.values())
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, state)
    other = build_train_setup(tcfg, batch, device="cpu", seed=4)
    restored = ckpt.restore(other.state)
    for k, c in state.center_state.items():
        assert torch.equal(restored.center_state[k], c), k
    old = {k: v for k, v in state_payload(state).items() if k != "center_state"}
    with pytest.raises(KeyError, match="centers"):
        load_payload(other.state, old)
    sk, _ = small_setup()
    zeros = {k: v.clone() for k, v in sk.state.center_state.items()}
    load_payload(sk.state, old)
    assert all(torch.equal(sk.state.center_state[k], zeros[k]) for k in zeros)


def test_latest_step_skips_torn_saves(tmp_path):
    from dinov3_tpu_torch.checkpoint import Checkpointer

    setup, _ = small_setup()
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, setup.state)
    ckpt.save(2, setup.state)
    plant_torn_saves(tmp_path)
    (tmp_path / "5").mkdir()  # a marker cut mid-write
    shutil.copy(tmp_path / "2" / "state.pt", tmp_path / "5" / "state.pt")
    (tmp_path / "5" / "FINALIZED").write_text('{"step": 5, "by')
    (tmp_path / "6").mkdir()  # a marker naming another step
    shutil.copy(tmp_path / "2" / "state.pt", tmp_path / "6" / "state.pt")
    (tmp_path / "6" / "FINALIZED").write_text(json.dumps(
        {"step": 2, "bytes": os.path.getsize(tmp_path / "2" / "state.pt")}))
    assert ckpt.steps() == [1, 2] and ckpt.latest_step() == 2
    assert ckpt.restore(setup.state).step == 0  # step 2 holds the state at step 0
    assert Checkpointer(tmp_path / "none").latest_step() is None
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "none").restore(setup.state)


@pytest.mark.parametrize("max_to_keep,keep_every,kept", [
    (3, None, [5, 6, 7]), (2, 3, [3, 6, 7]), (1, 2, [2, 4, 6, 7])])
def test_checkpoint_retention(tmp_path, max_to_keep, keep_every, kept):
    from dinov3_tpu_torch.checkpoint import Checkpointer

    setup, _ = small_setup()
    ckpt = Checkpointer(tmp_path, max_to_keep=max_to_keep, keep_every=keep_every)
    for step in range(1, 8):
        ckpt.save(step, setup.state)
    assert ckpt.steps() == kept and sorted(map(int, os.listdir(tmp_path))) == kept


# ---------------- the loop in this process ----------------

def test_three_non_finite_losses_abort_with_no_save_after_them(tmp_path, monkeypatch):
    """Batches 2, 3, 4 carry NaN pixels: the losses of iterations 2-4 are
    not finite and the third raises, before that iteration's save. The
    metrics ring is flushed every step here (``telemetry.flush_every=1``),
    so the host counts each loss as it comes; a wider window aborts at
    its next flush (``tests/test_torch_ring.py``)."""
    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.checkpoint import Checkpointer

    class Poisoned(T.SyntheticDataset):
        def _batch(self, i):
            batch = super()._batch(i)
            if i >= 2:
                batch["global_crops"] = np.full_like(batch["global_crops"], np.nan)
            return batch

    monkeypatch.setattr(T, "SyntheticDataset", Poisoned)
    cfg = port_cfg(tmp_path, ["checkpointing.period=1", "checkpointing.max_to_keep=10",
                              "telemetry.flush_every=1"])
    with pytest.raises(RuntimeError, match="3 consecutive non-finite losses"):
        T.do_train(cfg, port_args("--max-iterations", 8,
                                  "--record-losses", tmp_path / "l.jsonl"))
    assert Checkpointer(tmp_path / "ckpt").steps() == [1, 2, 3, 4]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2", "3", "4"]
    losses = read_losses(tmp_path / "l.jsonl")
    assert sorted(losses) == [0, 1, 2, 3, 4]
    assert [math.isfinite(losses[i]["total_loss"]) for i in range(5)] == [
        True, True, False, False, False]


def test_a_finite_loss_resets_the_non_finite_streak(tmp_path, monkeypatch):
    """Non-finite totals at iterations 1, 2, 4, 5: two in a row at most, so
    the run ends normally. The one-read-a-step path
    (``telemetry.async_metrics=false``), whose reads this patches; the
    ring's streak is held in ``tests/test_torch_ring.py``."""
    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.train import train_step

    read = train_step.StepMetrics.read
    calls = []

    def read_with_gaps(self):
        metrics = read(self)
        calls.append(len(calls))
        if calls[-1] in (1, 2, 4, 5):
            metrics["total_loss"] = math.nan
        return metrics

    monkeypatch.setattr(train_step.StepMetrics, "read", read_with_gaps)
    result = T.do_train(port_cfg(tmp_path, ["telemetry.async_metrics=false"]),
                        port_args("--max-iterations", 6))
    assert result["iterations"] == 6 and len(calls) == 6
    assert math.isnan(result["final_loss"])


def test_ref_losses_compare_against_a_file_the_jax_recorder_wrote(uninterrupted, tmp_path):
    """The port's losses rewritten by the JAX package's ``LossRecorder``:
    the port's ``--ref-losses`` reads them with no divergence, and one
    changed value diverges at its iteration; the JAX comparator reads the
    port's own file."""
    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu.utils import LossComparator as JaxComparator
    from dinov3_tpu.utils import LossRecorder as JaxRecorder

    d, _ = uninterrupted
    rows = read_losses(d / "a.jsonl")
    jc = JaxComparator(str(d / "a.jsonl"))
    assert all(jc.check(i, r) for i, r in rows.items()) and jc.n_checked == 4
    for name, bump in (("same", 0.0), ("bumped", 1.0)):
        rec = JaxRecorder(str(tmp_path / f"{name}.jsonl"))
        for i, r in rows.items():
            rec.record(i, {**r, "total_loss": r["total_loss"] + (bump if i == 2 else 0.0)})
        rec.close()
    # the file was recorded by a child process: compare at its thread count
    with cli_threads():
        same = T.do_train(port_cfg(tmp_path / "s"), port_args(
            "--max-iterations", 4, "--ref-losses", tmp_path / "same.jsonl"))
        bumped = T.do_train(port_cfg(tmp_path / "b"), port_args(
            "--max-iterations", 4, "--ref-losses", tmp_path / "bumped.jsonl"))
    assert same["loss_divergences"] == 0
    assert same["loss_comparison"].startswith("compared 4 iterations, 0 diverged")
    assert bumped["loss_divergences"] == 1 and "at iter 2" in bumped["loss_comparison"]


# ids as they were before the three M11 flags and the two Gram-anchor
# cases (now run, below) left the list. Distillation (M10) runs now
# (tests/test_torch_distill.py): its two ids check what of it still waits,
# multidistillation across processes (M7) and the hrft recipe's sequence
# mesh (M8)
@pytest.mark.parametrize("argv,extra,where", [
    pytest.param(["--resume-topology", "memory"], [], "M12", id="argv3-extra3-M12"),
    pytest.param([], ["multidistillation.enabled=true",
                      "multidistillation.students=[{name: a, config_path: x.yaml, "
                      "ranks_range: [0, 1]}, {name: b, config_path: x.yaml, "
                      "ranks_range: [1, 2]}]"], "M7", id="argv4-extra4-M10"),
    pytest.param([], ["hrft.enabled=true", "parallel.seq=4"], "M8", id="argv5-extra5-M10"),
    pytest.param([], ["parallel.fsdp=8"], "M7", id="argv8-extra8-M7"),
])
def test_trainer_refuses_what_waits_by_name(tmp_path, argv, extra, where):
    import dinov3_tpu_torch.train.train as T

    with pytest.raises(NotImplementedError, match=where):
        T.do_train(port_cfg(tmp_path, extra),
                   port_args("--max-iterations", 4, *argv))


def test_trainer_runs_the_m11_flags_it_used_to_refuse(tmp_path):
    """``--tensorboard``, ``--profile-steps`` and ``--debug-nans``, once
    refused by name (ROADMAP M11), run: the losses are those of the same
    run without them, bitwise; the trace window and the tensorboard
    directory are written; on the CPU the ledger is not made (it reads
    the card's kernels). The flags' own checks are in
    ``tests/test_torch_ring.py`` and ``tests/test_torch_anatomy.py``."""
    import dinov3_tpu_torch.train.train as T

    with cli_threads():
        plain = T.do_train(port_cfg(tmp_path / "plain"), port_args(
            "--max-iterations", 3, "--record-losses", tmp_path / "plain.jsonl"))
        flags = T.do_train(port_cfg(tmp_path / "flags"), port_args(
            "--max-iterations", 3, "--record-losses", tmp_path / "flags.jsonl",
            "--tensorboard", "--profile-steps", "0,1", "--debug-nans"))
    assert read_losses(tmp_path / "flags.jsonl") == read_losses(tmp_path / "plain.jsonl")
    assert flags["final_loss"] == plain["final_loss"] and "anatomy" not in flags
    assert Path(flags["trace"]).is_file() and flags["trace"].endswith(".trace.json.gz")
    assert (tmp_path / "flags" / "tb").is_dir() and any((tmp_path / "flags" / "tb").iterdir())
    assert not (tmp_path / "ckpt").exists()


def test_trainer_runs_the_gram_anchor_it_used_to_refuse(tmp_path):
    """``gram.ckpt`` and crop-size lists naming Gram teacher sizes, once
    refused by name (ROADMAP M12), run: a fresh Gram run whose
    ``gram.ckpt`` names another run's checkpoints starts from that run's
    EMA teacher at ``gram.it_load_ema_teacher`` (its saved Gram branch is
    that backbone, bit for bit, since no refresh falls in its one
    iteration); ``gram.ckpt`` without a Gram branch raises ``ValueError``,
    as in JAX; two (global, local, Gram) crop-size triples train with a
    finite Gram loss at both resolutions."""
    import dinov3_tpu_torch.train.train as T

    src = tmp_path / "src"
    T.do_train(port_cfg(src), port_args("--max-iterations", 4))
    assert sorted(os.listdir(src / "ckpt")) == ["2", "4"]
    gram = ["gram.use_loss=true", "crops.gram_teacher_crops_size=24"]
    anchored = T.do_train(
        port_cfg(tmp_path / "g", gram + [f"gram.ckpt={src / 'ckpt'}",
                                         "gram.it_load_ema_teacher=2"]),
        port_args("--max-iterations", 1, "--record-losses", tmp_path / "g.jsonl"))
    assert anchored["gram"] == "frozen" and math.isfinite(anchored["final_loss"])
    want = load_ckpt(src, 2)["teacher"]
    got = load_ckpt(tmp_path / "g", 1)["gram"]
    assert got.keys() == {k for k in want if k.startswith("backbone.")}
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert not torch.equal(got["backbone.cls_token"],
                           load_ckpt(src, 4)["teacher"]["backbone.cls_token"])
    with pytest.raises(ValueError, match="no gram branch"):
        T.do_train(port_cfg(tmp_path / "n", [f"gram.ckpt={src / 'ckpt'}"]),
                   port_args("--max-iterations", 1))
    lists = ["crops.global_crops_size=[16,24]", "crops.local_crops_size=[8,8]",
             "crops.gram_teacher_crops_size=[24,32]", "gram.use_loss=true"]
    multi = T.do_train(port_cfg(tmp_path / "l", lists), port_args(
        "--max-iterations", 4, "--record-losses", tmp_path / "l.jsonl"))
    rows = read_losses(tmp_path / "l.jsonl")
    assert multi["iterations"] == 4 and sorted(rows) == [0, 1, 2, 3]
    assert all(math.isfinite(r["gram_loss"]) and r["gram_loss"] > 0 for r in rows.values())


def test_dump_weights_writes_the_final_student_and_teacher(tmp_path):
    """``--dump-weights``: a flat ``.npz`` of the meta-arch's state after
    the last iteration, equal to the checkpoint the run saved there."""
    import dinov3_tpu_torch.train.train as T

    result = T.do_train(port_cfg(tmp_path), port_args(
        "--max-iterations", 2, "--dump-weights", tmp_path / "w.npz"))
    dumped = np.load(tmp_path / "w.npz")
    saved = load_ckpt(tmp_path, 2)
    want = {f"{role}/{n}".replace(".", "/"): t for role in ("student", "teacher")
            for n, t in saved[role].items()}
    assert set(dumped.files) == set(want) and result["dump_weights"]["arrays"] == len(want)
    for k, t in want.items():
        np.testing.assert_array_equal(dumped[k], t.float().numpy(), err_msg=k)


def test_crop_size_lists_run_and_resume_bitwise(tmp_path):
    """Two (global, local) crop-size pairs, each batch drawn from one by the
    seeded combiner: 5 iterations against 2 then a resume to 5, the same
    losses bit for bit; the choice stream gives both resolutions."""
    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.data import split_advance

    lists = ["crops.global_crops_size=[16,24]", "crops.local_crops_size=[8,8]"]
    assert all(split_advance(0, [1.0, 1.0], 5) > 0)

    def run(out, iters):
        return T.do_train(port_cfg(out, lists), port_args(
            "--max-iterations", iters, "--record-losses", out / f"{iters}.jsonl"))

    whole = run(tmp_path / "a", 5)
    assert run(tmp_path / "r", 2)["iterations"] == 2
    resumed = run(tmp_path / "r", 5)
    assert whole["start_iteration"] == 0 and resumed["start_iteration"] == 2
    want, got = read_losses(tmp_path / "a" / "5.jsonl"), read_losses(tmp_path / "r" / "5.jsonl")
    assert sorted(got) == [2, 3, 4] and all(got[i] == want[i] for i in got)
    assert all(math.isfinite(v) for row in want.values() for v in row.values())


def test_trainer_runs_on_the_card_unless_model_device_is_cpu(tmp_path):
    import dinov3_tpu_torch.train.train as T

    assert T.train_device(port_cfg(tmp_path)) == "cpu"
    for value in ("tpu", "cuda", "gpu"):
        assert T.train_device(port_cfg(tmp_path, [f"MODEL.DEVICE={value}"])) == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            T.do_train(port_cfg(tmp_path, ["MODEL.DEVICE=tpu"]),
                       port_args("--max-iterations", 1))


# ---------------- the step and the self-check ----------------

def test_the_step_reads_the_device_once(monkeypatch):
    """The step with ``Tensor.item`` made to raise: its metrics arrive by
    one ``tolist`` of one stacked tensor, equal to the unpatched step's."""
    want_setup, batch = small_setup()
    _, want = want_setup.step_fn(want_setup.state, batch, want_setup.scalars(0))
    setup, _ = small_setup()
    tolist = torch.Tensor.tolist
    reads = []

    def no_item(self):
        raise AssertionError("Tensor.item inside the step")

    def counted_tolist(self):
        reads.append(tuple(self.shape))
        return tolist(self)

    monkeypatch.setattr(torch.Tensor, "item", no_item)
    monkeypatch.setattr(torch.Tensor, "tolist", counted_tolist)
    state, pending = setup.launch_fn(setup.state, batch, setup.scalars(0))
    assert reads == [] and pending.values.shape == (len(pending.names),)
    got = pending.read()
    monkeypatch.undo()
    assert reads == [(len(want),)] and state.step == 1
    assert got == want and list(got) == list(want)
    assert set(LOSSES) < set(got)


def test_self_check_fails_a_frozen_submodule():
    from dinov3_tpu_torch.train.self_check import run_self_check

    setup, batch = small_setup()
    results = run_self_check(setup, batch)
    assert all(results.values()) and len(results) == 12
    frozen, batch = small_setup()
    opt = frozen.optimizer
    opt.lr_mult = [0.0 if n.startswith("dino_head.") else m
                   for n, m in zip(opt.names, opt.lr_mult)]
    results = run_self_check(frozen, batch)
    assert not results["student_updates:dino_head"]
    assert results["student_updates:backbone"] and results["student_updates:ibot_head"]
    assert results["step_counter_advances"]


# ---------------- the JAX checkpoint bridge ----------------

@pytest.fixture(scope="module")
def jax_world():
    """The JAX meta-arch with perturbed weights and one batch, as
    ``tests/test_torch_train.py``'s ``world`` fixture builds them."""
    from dinov3_tpu.data import make_synthetic_batch
    from dinov3_tpu.parallel.context import get_current_mesh, set_current_mesh
    from dinov3_tpu.train.ssl_meta_arch import SSLMetaArch as JMeta

    from test_torch_train import _noisy

    prev = get_current_mesh()
    set_current_mesh(None)
    jcfg, tcfg = cfgs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jmeta = JMeta(jcfg)
    batch = make_synthetic_batch(jcfg, B, seed=0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree.map(np.asarray, jmeta.init_params(jax.random.key(0), jbatch))
    params = {"student": _noisy(params["student"], 1),
              "teacher": _noisy(params["teacher"], 2)}
    set_current_mesh(prev)
    return {"jcfg": jcfg, "tcfg": tcfg, "jmeta": jmeta, "batch": batch,
            "jbatch": jbatch, "params": params}


def test_jax_checkpoint_restores_and_both_continue_alike(jax_world, tmp_path):
    """JAX ``make_train_step`` (fused update) takes 2 steps; the JAX
    package's own ``Checkpointer._local_save`` writes the state; the
    port's reader restores it into a port state built from other weights;
    both take 2 more steps on the same batch and drop-path plans."""
    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from dinov3_tpu.train.fused_update import build_fused_update
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState, make_train_step

    from dinov3_tpu_torch.checkpoint import jax_local_steps, restore_jax_local
    from dinov3_tpu_torch.interop import meta_state_dicts_from_jax
    from dinov3_tpu_torch.train import build_train_setup

    w = jax_world
    jcfg, jmeta, jbatch, params = w["jcfg"], w["jmeta"], w["jbatch"], w["params"]
    sched = jsched(jcfg)
    opt = build_optimizer(jcfg, params["student"], sched)
    fused = build_fused_update(jcfg, params["student"], sched, ema=True)
    jstep = jax.jit(make_train_step(jmeta, opt, clip_grad=jcfg.optim.clip_grad,
                                    fused_update=fused))
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        jmeta.init_state(), jnp.zeros((), jnp.int32))

    def scalars(i):
        s = sched.at(i)
        return {"teacher_temp": jnp.float32(s["teacher_temp"]),
                "momentum": jnp.float32(s["momentum"])}

    for i in range(2):
        jstate, _ = jstep(jstate, jbatch, scalars(i), jax.random.key(5))
    ckpt_dir = tmp_path / "jax"
    jax_ckpt = JaxCheckpointer(str(ckpt_dir), async_save=False)
    try:
        jax_ckpt._local_save(2, jstate)
    finally:
        jax_ckpt.close()
    assert jax_local_steps(str(ckpt_dir)) == [2]

    setup = build_train_setup(w["tcfg"], w["batch"], device="cpu", seed=11)
    state = restore_jax_local(str(ckpt_dir), setup.state)
    assert state.step == 2 and state.opt_state.count == 2  # Adam's bias correction
    host = jax.tree.map(np.asarray, jstate)
    want = meta_state_dicts_from_jax(host.params)
    for role in ("student", "teacher"):
        for n, t in getattr(state.meta, role).state_dict().items():
            assert torch.equal(t, want[role][n]), (role, n)
    moments = meta_state_dicts_from_jax({"mu": host.opt_state.adam.mu,
                                         "nu": host.opt_state.adam.nu})
    for (n, _), mu, nu in zip(state.meta.student.named_parameters(),
                              state.opt_state.mu, state.opt_state.nu):
        assert torch.equal(mu, moments["mu"][n]) and torch.equal(nu, moments["nu"][n]), n

    bound = 0.0
    for i in (2, 3):
        s = sched.at(i)
        jstate, jm = jstep(jstate, jbatch, scalars(i), jax.random.key(5))
        state, tm = setup.step_fn(state, w["batch"], setup.scalars(i),
                                  plan=_jax_plan(jmeta, jbatch, i))
        for k in LOSSES:
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
        bound += (1 - float(s["momentum"])) * 2 * float(s["lr"])
        want = meta_state_dicts_from_jax(
            {"t": jax.tree.map(np.asarray, jstate.params["teacher"])})["t"]
        got = state.meta.teacher.state_dict()
        close = total = 0
        for n, wt in want.items():
            wt = wt.numpy()
            err = np.abs(_np(got[n]) - wt)
            tol = 1e-5 * max(np.abs(wt).max(), 1e-3)
            assert (err <= tol + bound).all(), (i, n, err.max(), tol + bound)
            close += int((err <= tol).sum())
            total += err.size
        assert close >= 0.99 * total, (i, close, total)
    assert state.step == 4 and state.opt_state.count == 4
    assert int(jstate.opt_state.adam.count) == 4


def test_restore_jax_local_reads_the_center_state(jax_world, tmp_path):
    """A JAX local save whose ``center_state`` holds nonzero centers: the
    port restores them bit for bit, with the rest of the state."""
    from dinov3_tpu.checkpoint import Checkpointer as JaxCheckpointer
    from dinov3_tpu.train.optimizer import build_optimizer
    from dinov3_tpu.train.schedules import build_schedules as jsched
    from dinov3_tpu.train.train_step import TrainState

    from dinov3_tpu_torch.checkpoint import restore_jax_local
    from dinov3_tpu_torch.train import build_train_setup

    w = jax_world
    params = w["params"]
    opt = build_optimizer(w["jcfg"], params["student"], jsched(w["jcfg"]))
    rng = np.random.default_rng(5)
    centers = {k: jnp.asarray(rng.standard_normal((1, 64)).astype(np.float32))
               for k in ("dino_center", "ibot_center")}
    jstate = TrainState(jax.tree.map(jnp.asarray, params), opt.init(params["student"]),
                        centers, jnp.asarray(3, jnp.int32))
    jax_ckpt = JaxCheckpointer(str(tmp_path), async_save=False)
    try:
        jax_ckpt._local_save(3, jstate)
    finally:
        jax_ckpt.close()
    tcfg = cfgs(["train.centering=softmax_center"])[1]
    setup = build_train_setup(tcfg, w["batch"], device="cpu", seed=11)
    state = restore_jax_local(str(tmp_path), setup.state)
    assert state.step == 3
    for k, c in centers.items():
        assert torch.equal(state.center_state[k], torch.from_numpy(np.array(c))), k


def test_the_recipe_yaml_passes_the_slice_check_as_written():
    """``configs/train/vitl16_im1k.yaml`` with no loss, centering or batch
    override: nothing is refused; the step resolves streaming targets, no
    remat, no accumulation and B=64."""
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.configs.config import check_train_slice, streaming_targets_wished
    from dinov3_tpu_torch.models import remat_mode

    cfg = load_config(REPO / "configs" / "train" / "vitl16_im1k.yaml",
                      ["data.backend=synthetic"])
    check_train_slice(cfg)
    assert streaming_targets_wished(cfg) and cfg.loss.k_tile == 8192
    assert cfg.train.centering == "sinkhorn_knopp" and remat_mode(cfg) == "none"
    assert cfg.optim.accum_steps == 1 and cfg.train.batch_size_per_device == 64


def test_jax_npz_bf16_leaves_are_read_by_their_bits(tmp_path):
    """``np.savez`` stores a bf16 leaf as 2-byte void records; the bridge
    reads their bits as bf16 (no ``ml_dtypes`` needed on the reading side)."""
    from dinov3_tpu_torch.interop import state_dict_from_jax

    x = np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                               jnp.bfloat16))
    np.savez(tmp_path / "s.npz", x=x)
    with np.load(tmp_path / "s.npz") as z:
        stored = z["x"]
    assert stored.dtype.kind == "V" and stored.dtype.itemsize == 2
    sd = state_dict_from_jax({"norm": {"scale": stored[0], "bias": stored[1]},
                              "cls_token": stored})
    want = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    assert sd["norm.weight"].dtype == torch.bfloat16
    assert torch.equal(sd["norm.weight"], want[0]) and torch.equal(sd["cls_token"], want)
