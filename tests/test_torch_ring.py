"""The trainer's metrics ring and its flags (``dinov3_tpu_torch/telemetry/ring.py``,
``train/train_step.py make_telemetry_launch``, ``train/train.py``,
``debug_nans.py``, ``logging_utils.py``) on the CPU, against the JAX
package's ``RingReader`` and the port's own one-read-a-step oracle.

Tolerances: none. The ring stores the fp32 values the oracle reads, so
flushed rows, stamps and streaks are bitwise JAX's on the same sequence
and bitwise the oracle's in the trainer; a resumed run records the
uninterrupted run's losses bit for bit (equal thread counts, as in
``tests/test_torch_trainer.py``).
"""

import json
import math
import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dinov3_tpu.checkpoint  # noqa: F401  (see tests/test_torch_trainer.py)
from test_torch_trainer import (  # noqa: F401  (fixtures)
    _no_ambient_mesh,
    _process_state_unchanged,
    cli_threads,
    port_args,
    port_cfg,
    read_losses,
    small_setup,
)

NAMES = ["aux", "total_loss"]


def _jax_ring_run(K, seq, flush_at, start=0):
    """JAX's ring over ``seq`` (loss values; aux = 2 * it + 1), flushed
    at the iterations in ``flush_at``: [(its, rows, streak)]."""
    from dinov3_tpu.telemetry.ring import RingReader, make_ring, write_row

    ring = jax.device_put(make_ring(len(NAMES), K))
    step = jax.jit(lambda r, it, v, a: write_row(
        r, it, {"total_loss": v, "aux": a}, NAMES))
    reader = RingReader(NAMES, K, start_iteration=start)
    out = []
    for it, v in enumerate(seq):
        ring = step(ring, jnp.int32(it), jnp.float32(v), jnp.float32(2 * it + 1))
        if it in flush_at:
            out.append(reader.flush(ring, it + 1))
    return out


def _port_ring_run(K, seq, flush_at, start=0):
    from dinov3_tpu_torch.telemetry import RingReader, make_ring, write_row

    ring = make_ring(len(NAMES), K)
    reader = RingReader(NAMES, K, start_iteration=start)
    out = []
    for it, v in enumerate(seq):
        write_row(ring, it, torch.tensor([2 * it + 1, v], dtype=torch.float32),
                  NAMES.index("total_loss"))
        if it in flush_at:
            out.append(reader.flush(ring, it + 1))
    return out


def _same_flushes(got, want):
    assert len(got) == len(want)
    for (gi, gr, gs), (wi, wr, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gr.dtype == np.float32 and gr.tobytes() == np.asarray(wr).tobytes()
        assert gs == ws


def test_ring_wraparound_and_reader_windows_equal_jax():
    """10 writes through a K=4 ring, flushed in two full windows and a
    partial one: every row back exact, in order, as JAX's reader gives."""
    seq = [it + 0.5 for it in range(10)]
    got = _port_ring_run(4, seq, (3, 7, 9))
    _same_flushes(got, _jax_ring_run(4, seq, (3, 7, 9)))
    assert np.concatenate([g[0] for g in got]).tolist() == list(range(10))
    assert all(g[2] == 0 for g in got)


def test_ring_reader_rejects_bad_windows_with_jax_messages():
    from dinov3_tpu.telemetry.ring import RingReader as JReader
    from dinov3_tpu.telemetry.ring import make_ring as j_make
    from dinov3_tpu.telemetry.ring import write_row as j_write

    from dinov3_tpu_torch.telemetry import RingReader, make_ring, write_row

    K = 4
    ring = make_ring(len(NAMES), K)
    jring = jax.device_put(j_make(len(NAMES), K))
    for it in range(6):
        write_row(ring, it, torch.tensor([0.0, 1.0]), 1)
        jring = j_write(jring, jnp.int32(it), {"aux": jnp.float32(0), "total_loss":
                                               jnp.float32(1)}, NAMES)
    for reader, r in ((RingReader, ring), (JReader, jring)):
        with pytest.raises(RuntimeError, match="does not fit the ring"):
            reader(NAMES, K).flush(r, 6)
        with pytest.raises(RuntimeError, match="stamp mismatch"):
            reader(NAMES, K, start_iteration=0).flush(r, 2)
        its, _, _ = reader(NAMES, K, start_iteration=4).flush(r, 6)
        assert its.tolist() == [4, 5]
    with pytest.raises(ValueError, match="scalar metrics"):
        write_row(ring, 6, torch.zeros(3), 1)


def test_non_finite_streak_across_flushes_equals_jax():
    """Grows on consecutive non-finite losses, resets on a finite one,
    and keeps counting across a flush, as JAX's device streak does."""
    from dinov3_tpu_torch.telemetry import make_ring, write_row

    seq = [1.0, math.nan, math.inf, 1.0, math.nan, math.nan, math.nan, 2.0]
    flush_at = (2, 5, 6, 7)
    _same_flushes(_port_ring_run(3, seq, flush_at), _jax_ring_run(3, seq, flush_at))
    ring = make_ring(2, 3)
    for it, (v, want) in enumerate(zip(seq, [0, 1, 2, 0, 1, 2, 3, 0])):
        write_row(ring, it, torch.tensor([0.0, v]), 1)
        assert int(ring.nonfinite_streak) == want


def test_the_ring_step_writes_the_oracle_s_metrics_bitwise():
    """The telemetry launch of the CPU trainer's step (``vit_test`` width)
    against ``launch_fn`` + its one read, from the same weights and batch
    over three steps: each flushed row is the oracle's metrics, bitwise,
    and the launch reads nothing from the device."""
    oracle, batch = small_setup()
    ring_setup, _ = small_setup()
    plan = ring_setup.telemetry
    assert plan is not None and plan.metric_names[-3:] == [
        "grad_norm/backbone", "grad_norm/dino_head", "grad_norm/ibot_head"]
    ring, reader = plan.init_ring(), plan.reader()
    want, s_o, s_r = [], oracle.state, ring_setup.state
    for i in range(3):
        s_o, m = oracle.launch_fn(s_o, batch, oracle.scalars(i))
        want.append(m.read())
        assert m.names == plan.metric_names
        s_r, ring = plan.launch_fn(s_r, ring, batch, ring_setup.scalars(i))
    its, rows, streak = reader.flush(ring, 3)
    assert its.tolist() == [0, 1, 2] and streak == 0
    for row, w in zip(rows, want):
        assert [float(v) for v in row] == [w[n] for n in plan.metric_names]


def test_trainer_ring_and_oracle_record_the_same_losses(tmp_path):
    """``do_train`` with the ring (flushed every 2 of 5 iterations) and
    with ``telemetry.async_metrics=false``: the recorded losses, the
    final loss and the checkpoints are bitwise alike; the ring costs one
    fetch a flush and the spans name each phase."""
    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.telemetry import load_span_streams

    with cli_threads():
        ring = T.do_train(port_cfg(tmp_path / "ring", ["telemetry.flush_every=2"]),
                          port_args("--max-iterations", 5, "--record-losses",
                                    tmp_path / "ring.jsonl"))
        oracle = T.do_train(port_cfg(tmp_path / "oracle", ["telemetry.async_metrics=false"]),
                            port_args("--max-iterations", 5, "--record-losses",
                                      tmp_path / "oracle.jsonl"))
    assert ring["metrics"] == "ring" and oracle["metrics"] == "per-step read"
    a, b = read_losses(tmp_path / "ring.jsonl"), read_losses(tmp_path / "oracle.jsonl")
    assert sorted(a) == list(range(5)) and a == b
    assert list(a[0]) == list(b[0])  # the same column order in the file
    assert ring["final_loss"] == oracle["final_loss"]
    assert ring["host_sync"]["fetches"] == 3 and oracle["host_sync"]["fetches"] == 0
    for step in (2, 4, 5):
        x = torch.load(tmp_path / "ring" / "ckpt" / str(step) / "state.pt", weights_only=True)
        y = torch.load(tmp_path / "oracle" / "ckpt" / str(step) / "state.pt", weights_only=True)
        assert all(torch.equal(x["student"][n], y["student"][n]) for n in x["student"])
    (stream,) = load_span_streams(str(tmp_path / "ring")).values()
    names = [r["name"] for r in stream]
    assert {"data_wait", "dispatch", "h2d", "metrics_flush", "checkpoint_save",
            "memory"} <= set(names)
    assert names.count("metrics_flush") == 3 and names.count("dispatch") == 5
    assert [r["point"] for r in stream if r["name"] == "memory"][:2] == ["setup", "compile"]
    assert os.path.isfile(tmp_path / "ring" / "telemetry" / "heartbeat.train")


def test_resume_mid_ring_records_the_uninterrupted_losses(tmp_path):
    """A run stopped at iteration 3 with a ring of 2 (its last window
    partial) and resumed to 6 in a new ``do_train`` records iterations
    3-5 as the uninterrupted run does, bitwise."""
    import dinov3_tpu_torch.train.train as T

    extra = ["telemetry.flush_every=2", "checkpointing.period=3"]
    with cli_threads():
        T.do_train(port_cfg(tmp_path / "full", extra), port_args(
            "--max-iterations", 6, "--record-losses", tmp_path / "full.jsonl"))
        T.do_train(port_cfg(tmp_path / "cut", extra), port_args(
            "--max-iterations", 3, "--record-losses", tmp_path / "first.jsonl"))
        resumed = T.do_train(port_cfg(tmp_path / "cut", extra), port_args(
            "--max-iterations", 6, "--record-losses", tmp_path / "second.jsonl"))
    assert resumed["start_iteration"] == 3
    full = read_losses(tmp_path / "full.jsonl")
    first, second = read_losses(tmp_path / "first.jsonl"), read_losses(tmp_path / "second.jsonl")
    assert sorted(first) == [0, 1, 2] and sorted(second) == [3, 4, 5]
    assert {**first, **second} == full


def test_three_non_finite_losses_abort_at_the_next_flush(tmp_path, monkeypatch):
    """Batches from iteration 2 on carry NaN pixels. With a ring of 4 the
    host's count of the flushed losses is 2 at the first flush (no abort)
    and 6 at the second, which aborts before that iteration's save; every
    row was recorded."""
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
                              "telemetry.flush_every=4"])
    with pytest.raises(RuntimeError, match="6 consecutive non-finite losses"):
        T.do_train(cfg, port_args("--max-iterations", 10,
                                  "--record-losses", tmp_path / "l.jsonl"))
    assert Checkpointer(tmp_path / "ckpt").steps() == list(range(1, 8))
    losses = read_losses(tmp_path / "l.jsonl")
    assert sorted(losses) == list(range(8))
    assert [math.isfinite(losses[i]["total_loss"]) for i in range(8)] == [
        True, True] + [False] * 6


def test_three_non_finite_losses_then_a_finite_one_in_a_window_abort(tmp_path, monkeypatch):
    """The ring's rows of iterations 1-3 carry a NaN total loss and those
    after them are finite again (the weights stay finite). One window of 8
    holds them all: the device streak is 0 at its end, but the host counts
    the flushed losses in order and aborts, as the one-read-a-step path
    does."""
    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.train import train_step

    write = train_step.write_row

    def write_with_nans(ring, iteration, values, loss_col):
        if iteration in (1, 2, 3):
            values = values.clone()
            values[loss_col] = math.nan
        return write(ring, iteration, values, loss_col)

    monkeypatch.setattr(train_step, "write_row", write_with_nans)
    cfg = port_cfg(tmp_path, ["telemetry.flush_every=8"])
    with pytest.raises(RuntimeError, match="3 consecutive non-finite losses"):
        T.do_train(cfg, port_args("--max-iterations", 8,
                                  "--record-losses", tmp_path / "l.jsonl"))
    losses = read_losses(tmp_path / "l.jsonl")
    assert [math.isfinite(losses[i]["total_loss"]) for i in range(8)] == [
        True, False, False, False, True, True, True, True]


def _plant(monkeypatch, where: str):
    """Make the first block MLP's GELU output carry a NaN, made by
    ``aten.mul`` in the forward, or make its gradient carry one, made by
    ``aten.mul`` in the backward of a planted autograd node."""
    from dinov3_tpu_torch.ops import ffn

    gelu = ffn.exact_gelu

    class _PlantNan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g.mul(float("nan"))

    def planted(x):
        y = gelu(x)
        if where == "forward":
            return y.mul(float("nan"))
        return _PlantNan.apply(y) if y.requires_grad else y

    monkeypatch.setattr(ffn, "exact_gelu", planted)


@pytest.mark.parametrize("where,match", [
    ("forward", r"aten\.mul\.Tensor produced a NaN in the forward"),
    ("backward", r"aten\.mul\.Tensor produced a NaN in the backward \(_PlantNanBackward"),
])
def test_debug_nans_names_a_planted_op(tmp_path, monkeypatch, where, match):
    """``--debug-nans`` raises at the op that made the NaN and names it,
    in the forward and in the backward (the autograd engine's ops run
    under the mode too); without the flag the planted NaN only shows as
    non-finite losses."""
    import dinov3_tpu_torch.train.train as T

    _plant(monkeypatch, where)
    with pytest.raises(FloatingPointError, match=match):
        T.do_train(port_cfg(tmp_path / "on"), port_args("--max-iterations", 2,
                                                         "--debug-nans"))
    off = T.do_train(port_cfg(tmp_path / "off", ["telemetry.flush_every=1"]),
                     port_args("--max-iterations", 2))
    assert math.isnan(off["final_loss"])


def _tb_scalars(tb_dir) -> dict:
    """{tag: [(step, value)]} from the event files under ``tb_dir``
    (TFRecord framing: length, its crc, the Event proto, its crc)."""
    from tensorboardX.proto import event_pb2

    out: dict = {}
    for name in sorted(os.listdir(tb_dir)):
        with open(os.path.join(tb_dir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos: pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12: pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                out.setdefault(v.tag, []).append((ev.step, v.simple_value))
    return out


def test_tensorboard_events_read_back(tmp_path):
    """``--tensorboard`` writes the meters to ``<output-dir>/tb`` at each
    logged iteration (here the first: the loop logs every 10th); the
    events hold the recorded losses' medians."""
    import dinov3_tpu_torch.train.train as T

    T.do_train(port_cfg(tmp_path, ["telemetry.flush_every=1"]),
               port_args("--max-iterations", 2, "--tensorboard",
                         "--record-losses", tmp_path / "l.jsonl"))
    scalars = _tb_scalars(tmp_path / "tb")
    assert {"total_loss", "lr", "iter_time", "grad_norm/backbone"} <= set(scalars)
    assert [s for s, _ in scalars["total_loss"]] == [0]
    losses = read_losses(tmp_path / "l.jsonl")
    assert scalars["total_loss"][0][1] == pytest.approx(losses[0]["total_loss"], rel=1e-6)


def test_tensorboard_without_a_writer_warns_and_keeps_json(tmp_path, monkeypatch, caplog):
    """Where neither tensorboardX nor torch.utils.tensorboard imports, the
    flag logs the reference's warning and the run keeps its JSON lines."""
    import builtins

    from dinov3_tpu_torch.logging_utils import LOGGER_NAME, MetricLogger

    real_import = builtins.__import__

    def no_tb(name, *args, **kwargs):
        if name in ("tensorboardX", "torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    with caplog.at_level("WARNING", logger=LOGGER_NAME):
        ml = MetricLogger(output_file=str(tmp_path / "m.json"),
                          tensorboard_dir=str(tmp_path / "tb"))
    assert "neither tensorboardX nor torch.utils.tensorboard" in caplog.text
    ml.update(total_loss=1.5)
    ml.dump_json(0, 0.1, 0.0)
    ml.close()
    assert json.loads((tmp_path / "m.json").read_text())["total_loss"] == 1.5
    assert not (tmp_path / "tb").exists()


def test_warn_telemetry_flush_period_equals_jax():
    from dinov3_tpu.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu.configs.config import warn_telemetry_flush_period as j_warn

    from dinov3_tpu_torch.configs.config import get_default_config as t_default
    from dinov3_tpu_torch.configs.config import apply_dot_overrides as t_apply
    from dinov3_tpu_torch.configs.config import warn_telemetry_flush_period

    for over in (["checkpointing.period=100", "evaluation.eval_period_iterations=200",
                  f"telemetry.flush_every={k}"] for k in (50, 150, 250)):
        for off in ([], ["telemetry.async_metrics=false"]):
            jcfg, tcfg = get_default_config(), t_default()
            apply_dot_overrides(jcfg, over + off)
            t_apply(tcfg, over + off)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert warn_telemetry_flush_period(tcfg) == j_warn(jcfg)


def test_consume_flush_and_loss_tools_take_flushed_windows(tmp_path):
    """The meters, the recorder and the comparator take a flushed window
    row by row as the oracle's per-step calls do."""
    from dinov3_tpu_torch.logging_utils import MetricLogger
    from dinov3_tpu_torch.utils import LossComparator, LossRecorder

    its = np.arange(3, 6)
    rows = np.asarray([[1.0, 0.5], [2.0, np.nan], [3.0, 0.25]], np.float32)
    a, b = MetricLogger(), MetricLogger()
    a.consume_flush(NAMES, its, rows, scheds=lambda i: {"lr": i * 0.1})
    for i, r in zip(its, rows):
        b.update(aux=float(r[0]), total_loss=float(r[1]), lr=i * 0.1)
    assert {k: m.deque for k, m in a.meters.items()}.keys() == b.meters.keys()
    for k in a.meters:
        assert str(list(a.meters[k].deque)) == str(list(b.meters[k].deque))
    rec = LossRecorder(str(tmp_path / "r.jsonl"))
    rec.record_batch(its, NAMES, rows)
    rec.close()
    got = read_losses(tmp_path / "r.jsonl")
    assert sorted(got) == [3, 4, 5] and got[5] == {"aux": 3.0, "total_loss": 0.25}
    cmp = LossComparator(str(tmp_path / "r.jsonl"))
    assert cmp.check_batch(its[[0, 2]], NAMES, rows[[0, 2]])
    assert not cmp.check_batch(its[:1], NAMES, rows[:1] + 1.0)
