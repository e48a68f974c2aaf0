"""DINOv3 pretraining on one card (``dinov3_tpu/train/train.py``).

    python -m dinov3_tpu_torch.train.train \\
        --config-file configs/train/vitl16_im1k.yaml --output-dir build/run \\
        --max-iterations 4 --benchmark 2 data.backend=synthetic \\
        checkpointing.period=2

``MODEL.DEVICE=cpu`` runs on the CPU with the kernels' plain versions; any
other value (the default ``tpu`` included) runs on the card and raises
without one. Run again with the same ``--output-dir`` and the run resumes
from its newest finalized checkpoint, the data stream advanced to it
(``--no-resume`` starts over). The last line of standard output is the
run's result as one JSON object.

Each iteration queues the step on the device with no host read and hands
the next batch (made, and pinned for the card, on a producer thread) to
the device. By default (``telemetry.async_metrics`` auto) the step writes
its metrics into a device ring (``telemetry/ring.py``) and the host reads
the ring once per ``telemetry.flush_every`` iterations with one fetch,
replaying the rows into the meters, ``--record-losses`` and
``--ref-losses``; three non-finite losses in a row, counted on the device,
abort the run with ``RuntimeError`` at the next flush.
``telemetry.async_metrics=false`` reads each step's metrics in one
transfer instead (the oracle). A checkpoint is saved every
``checkpointing.period`` iterations and at the last. Set-up garbage is
collected once and frozen, so the collector's later passes do not walk
it.

The loop's phases (data wait, h2d, dispatch, metrics flush or fetch,
eval, checkpoint save) are spans in ``<output-dir>/telemetry/spans.jsonl``
with a heartbeat, memory samples at set-up, after the first step and at
each flush, and the ``telemetry.flush_deadline_s`` watchdog on the flush
(``telemetry/``). ``--profile-steps a,b`` records iterations a..b with
``torch.profiler`` into ``<output-dir>/trace/*.trace.json.gz`` and writes
the step-anatomy ledger beside it as ``anatomy.json`` (device ms by kernel
category and named scope, per iteration; ``telemetry/anatomy.py``), with
an ``anatomy`` span record; the window must end before ``--benchmark``'s
timed iterations begin. ``--tensorboard`` mirrors the meters to
``<output-dir>/tb`` (``tensorboardX``, else ``torch.utils.tensorboard``,
else a warning). ``--debug-nans`` raises at the first op that makes a NaN,
naming it and whether it ran in the forward or the backward
(``debug_nans.py``).

Every ``evaluation.eval_period_iterations`` iterations the EMA teacher's
backbone is evaluated in place (``evals.do_eval``: k-NN and a linear
probe on its frozen features); each result is appended to
``<output-dir>/evals.json`` and its seconds are kept out of the
``--benchmark`` step times. The eval reads the teacher and draws from no
generator the step uses: a run's losses are those of the same run
without evals.

Crop-size lists (``crops.global_crops_size: [224, 256]`` with a local
list of the same length) draw each batch from one resolution's stream
(``data/multires.py``), resumably. ``--dump-weights f.npz`` writes the
final student and teacher as a flat ``.npz`` (``utils.dump_weights``).
``train.scan_layers`` is an XLA compile option: the port's block stack is
unrolled whatever it says, and the run logs it.

``train.low_precision.arm=fp8|int8`` runs the block products quantized
(``ops/lowp.py``); the drift probe's result is logged at set-up.

Refused at start, each naming the ROADMAP item it waits for: distillation, multidistillation, high-res fine-tuning and
pretrained weights (M10), the Gram anchor, its refresh and crop-size
lists naming Gram teacher sizes (M12), sharded meshes (M7,
``configs/config.py``) and an elastic ``--resume-topology`` (M12). There is no preemption handler
(M12): a signal ends the run, and the next one resumes from the last
finalized checkpoint.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from dinov3_tpu_torch.checkpoint import Checkpointer
from dinov3_tpu_torch.configs import global_batch_size, load_config, setup_job
from dinov3_tpu_torch.configs.config import anatomy_wished
from dinov3_tpu_torch.data import (
    CombineDataLoader,
    SyntheticDataset,
    multires_subconfigs,
    split_advance,
)
from dinov3_tpu_torch.data.loaders import BackgroundIterator
from dinov3_tpu_torch.logging_utils import (
    LOGGER_NAME,
    MetricLogger,
    remove_handlers,
    setup_logging,
)
from dinov3_tpu_torch.ops._cuda import build_kernels
from dinov3_tpu_torch.ops.common import resolve_device
from dinov3_tpu_torch.ops.flash_attention import FLASH_BWD_DKV, FLASH_BWD_DQ, FLASH_FWD
from dinov3_tpu_torch.ops.fused_norm import LAYERNORM_BWD, LAYERNORM_FWD
from dinov3_tpu_torch.debug_nans import DebugNans
from dinov3_tpu_torch.telemetry import (
    SpanTracer,
    StepTimer,
    Watchdog,
    emit_step_anatomy,
    host_sync_stats,
)
from dinov3_tpu_torch.train.setup import build_train_setup
from dinov3_tpu_torch.train.train_step import put_batch
from dinov3_tpu_torch.utils import (
    LossComparator,
    LossRecorder,
    count_parameters,
    format_parameter_counts,
)

logger = logging.getLogger(LOGGER_NAME)

# the kernels of the training step, by the names the records use
KERNELS = {"K1": FLASH_FWD, "K2": FLASH_BWD_DQ, "K3": FLASH_BWD_DKV,
           "K4": LAYERNORM_FWD, "K5": LAYERNORM_BWD}

def get_args_parser():
    p = argparse.ArgumentParser("DINOv3 pretraining on one card")
    p.add_argument("--config-file", default="", help="run recipe YAML")
    p.add_argument("--output-dir", default=".", help="logs + checkpoints")
    p.add_argument("--no-resume", action="store_true",
                   help="do not resume from the latest checkpoint")
    p.add_argument("--profile-steps", default="",
                   help="'start,stop': trace iterations start..stop with "
                        "torch.profiler and write <output-dir>/trace/anatomy.json")
    p.add_argument("--max-iterations", type=int, default=-1,
                   help="hard cap on iterations")
    p.add_argument("--record-losses", default="",
                   help="write per-iteration losses to this JSON-lines file")
    p.add_argument("--ref-losses", default="",
                   help="compare per-iteration losses against a recorded file")
    p.add_argument("--dump-weights", default="",
                   help="dump the final student and teacher to this .npz")
    p.add_argument("--benchmark", type=int, default=0, metavar="N",
                   help="time the last N iterations and report img/s")
    p.add_argument("--self-check", action="store_true",
                   help="run two steps on one batch (losses finite, every "
                        "submodule trains, the teacher EMA tracks) and exit")
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror the meters to tensorboard events in <output-dir>/tb")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first op that makes a NaN, naming it")
    p.add_argument("--resume-topology", default="auto",
                   choices=("auto", "memory", "disk"),
                   help="elastic resume path; only 'auto' (one card) runs")
    p.add_argument("opts", nargs="*", default=[],
                   help="key.path=value config overrides")
    return p


def train_device(cfg) -> str:
    """``MODEL.DEVICE``: ``cpu`` is the CPU, anything else the card."""
    value = str((cfg.get("MODEL") or {}).get("DEVICE", "tpu") or "tpu")
    return "cpu" if value.lower() == "cpu" else "cuda"


def total_iterations(cfg, args) -> int:
    total = cfg.optim.epochs * cfg.train.OFFICIAL_EPOCH_LENGTH
    return min(total, args.max_iterations) if args.max_iterations > 0 else total


def refuse_waiting(cfg, args, total_iters: int) -> None:
    """Raise ``NotImplementedError`` for what this trainer does not run,
    naming where it waits; nothing is skipped quietly."""
    if args.resume_topology != "auto":
        raise NotImplementedError(
            f"--resume-topology {args.resume_topology}: elastic resume waits "
            "(ROADMAP M12)")
    s = cfg.student
    waits = [
        (bool(cfg.distillation.enabled), "distillation waits (ROADMAP M10)"),
        (bool(cfg.multidistillation.enabled),
         "multidistillation waits (ROADMAP M10)"),
        (bool(cfg.hrft.enabled), "hrft (high-res fine-tuning) waits (ROADMAP M10)"),
        (bool(s.get("pretrained_weights") or s.get("resume_from_teacher_chkpt")),
         "pretrained student weights wait (ROADMAP M10)"),
        (bool(cfg.gram.get("ckpt")) or bool(cfg.gram.use_loss and cfg.gram.rep_update
                                            and not cfg.gram.ema_teacher),
         "the Gram anchor and its refresh wait (ROADMAP M12)"),
        (isinstance(cfg.crops.global_crops_size, (list, tuple))
         and bool(cfg.crops.get("gram_teacher_crops_size")),
         "crop-size lists naming Gram teacher sizes wait with the Gram anchor "
         "(ROADMAP M12)"),
    ]
    for refused, msg in waits:
        if refused:
            raise NotImplementedError(msg)


def profile_window(args, total_iters: int) -> tuple[int, int] | None:
    """``--profile-steps a,b`` -> (a, b), checked: 0 <= a <= b, and the
    window ends before ``--benchmark``'s timed iterations (and their
    leading mark) begin, since the profiler costs time inside it."""
    if not args.profile_steps:
        return None
    try:
        a, b = (int(x) for x in args.profile_steps.split(","))
    except ValueError as e:
        raise ValueError(f"--profile-steps wants 'start,stop', got "
                         f"{args.profile_steps!r}") from e
    if not 0 <= a <= b:
        raise ValueError(f"--profile-steps {a},{b}: need 0 <= start <= stop")
    if args.benchmark and b >= total_iters - args.benchmark - 1:
        raise ValueError(
            f"--profile-steps {a},{b} overlaps --benchmark {args.benchmark}'s timed "
            f"iterations (from {total_iters - args.benchmark - 1} of {total_iters}); "
            "profile earlier iterations or run them apart")
    return a, b


def pin_batch(batch: dict) -> dict:
    """numpy batch -> CPU tensors in pinned memory (for the card's copy)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in batch.items()}


def build_data_iterator(cfg, batch_size: int, start_iter: int = 0,
                        pin: bool = False):
    """Host batches on a producer thread, starting at batch ``start_iter``
    (resume). Close it to stop the thread. ``pin``: hand the synthetic
    batches over in pinned memory. With crop-size lists, one stream per
    resolution (the synthetic one of resolution j seeded ``train.seed +
    7919 j``, as in the JAX trainer), combined by ``CombineDataLoader``."""
    backend = cfg.data.backend
    if backend == "synthetic":
        subs = multires_subconfigs(cfg)
        if subs is None:
            source = SyntheticDataset(cfg, batch_size, seed=cfg.train.seed,
                                      advance=start_iter)
        else:
            ratios = [r for _, r in subs]
            counts = split_advance(cfg.train.seed, ratios, start_iter)
            source = CombineDataLoader(
                [SyntheticDataset(sub, batch_size, seed=cfg.train.seed + 7919 * j,
                                  advance=int(counts[j]))
                 for j, (sub, _) in enumerate(subs)], ratios, seed=cfg.train.seed)
            source.advance(start_iter)
        return BackgroundIterator(source, depth=int(cfg.data.get("prefetch", 2) or 2),
                                  transform=pin_batch if pin else None)
    if backend in ("folder", "imagenet"):
        from dinov3_tpu_torch.data.pipeline import make_multires_train_pipeline

        return make_multires_train_pipeline(cfg, batch_size,
                                            sampler_advance_batches=start_iter)
    raise ValueError(f"unknown data backend {backend!r}")


def resolved_engine(setup) -> dict:
    """What the step resolved from the config: the target engine
    (streaming or materialized), the centering, the K-tile cap, the
    student's activation checkpointing and the accumulation steps."""
    meta = setup.meta
    return {"targets": "streaming" if meta.streaming_targets else "materialized",
            "centering": meta.centering, "k_tile": meta.loss_k_tile,
            "remat": meta.student["backbone"].remat,
            "accum_steps": int(setup.cfg.optim.get("accum_steps", 1) or 1),
            "crop_packing": meta.crop_packing, "rng_plan": meta.rng_plan,
            # an XLA compile option: the port's block stack is unrolled
            "scan_layers": bool(setup.cfg.train.get("scan_layers", False)),
            "lowp_arm": setup.lowp["arm"],
            "metrics": "ring" if setup.telemetry is not None else "per-step read"}


def run_eval(cfg, teacher_backbone, it: int, out_dir: str) -> dict:
    """``do_eval`` on the teacher's backbone after iteration ``it``; its
    record ``{"iteration": it + 1, **results}`` is appended to
    ``<out_dir>/evals.json`` and returned with the eval's seconds (the
    first eval's import of the eval modules, PIL among them, included)."""
    device = next(teacher_backbone.parameters()).device
    if device.type == "cuda":  # the step's queued work stays out of the eval's time
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    from dinov3_tpu_torch.evals import do_eval

    results = do_eval(cfg, teacher_backbone)
    seconds = time.perf_counter() - t0
    record = {"iteration": it + 1, **results}
    with open(f"{out_dir}/evals.json", "a") as f:
        f.write(json.dumps(record) + "\n")
    logger.info("eval at iteration %d: %s in %.1f s", it + 1, results, seconds)
    return {**record, "seconds": seconds}


class _GcTimes:
    """Times the collector's passes while installed (``gc.callbacks``)."""

    def __init__(self):
        self.ms: dict = {}
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms.setdefault(info["generation"], []).append(
                (time.perf_counter() - self._t0) * 1e3)

    def summary(self) -> dict:
        return {f"gen{g}": {"n": len(v), "max_ms": max(v), "total_ms": sum(v)}
                for g, v in sorted(self.ms.items())}


def do_train(cfg, args) -> dict:
    device = resolve_device(train_device(cfg))
    B = global_batch_size(cfg, 1)
    total_iters = total_iterations(cfg, args)
    refuse_waiting(cfg, args, total_iters)
    prof = profile_window(args, total_iters)
    with DebugNans() if args.debug_nans else contextlib.nullcontext():
        return _do_train(cfg, args, device, B, total_iters, prof)


def _do_train(cfg, args, device, B: int, total_iters: int, prof) -> dict:
    if device.type == "cuda":
        build_kernels(list(KERNELS.values()))  # one nvcc each, in parallel
    out_dir = cfg.train.output_dir
    os.makedirs(out_dir, exist_ok=True)
    ckpt = Checkpointer(f"{out_dir}/ckpt", max_to_keep=cfg.checkpointing.max_to_keep,
                        keep_every=cfg.checkpointing.get("keep_every"))
    # the resume point decides where the data stream starts: known before
    # the iterator is built
    latest = None if args.no_resume else ckpt.latest_step()
    start_iter = latest or 0
    data_iter = build_data_iterator(cfg, B, start_iter=start_iter,
                                    pin=device.type == "cuda")
    tele_cfg = cfg.get("telemetry") or {}
    tracer = SpanTracer(
        out_dir, enabled=bool(tele_cfg.get("spans", True)),
        heartbeat_every=int(tele_cfg.get("heartbeat_every", 1)),
        profile_steps=prof, profile_dir=f"{out_dir}/trace",
        flush_every_emits=int(tele_cfg.get("span_autoflush_every", 32)))
    # a metrics flush slower than the deadline emits a stall span (0: off)
    watchdog = Watchdog(tracer, deadline_s=float(tele_cfg.get("flush_deadline_s", 0.0) or 0.0))
    memory_on = bool(tele_cfg.get("memory", True)) and tracer.enabled
    recorder = metric_logger = None
    gc_times = _GcTimes()
    frozen = False
    try:
        first = next(data_iter)
        t0 = time.perf_counter()
        setup = build_train_setup(cfg, first, device=device, seed=cfg.train.seed)
        logger.info("device %s | batch %d | setup %.1f s", device, B,
                    time.perf_counter() - t0)
        if memory_on:
            tracer.emit_memory("setup")
        engine = resolved_engine(setup)
        logger.info("targets %s (%s, k_tile %d) | remat %s | accum_steps %d | "
                    "crop_packing %s | rng.plan %s | lowp %s | metrics %s",
                    engine["targets"], engine["centering"], engine["k_tile"],
                    engine["remat"], engine["accum_steps"], engine["crop_packing"],
                    engine["rng_plan"], engine["lowp_arm"], engine["metrics"])
        if setup.lowp_drift is not None:
            logger.info("lowp drift probe (%s): max %.4g against divergence_tol %.4g: %s",
                        engine["lowp_arm"], setup.lowp_drift["max"],
                        setup.lowp["divergence_tol"], setup.lowp_drift)
        if engine["scan_layers"]:
            logger.info("train.scan_layers=true is an XLA compile option; the "
                        "port runs its block stack unrolled, the same numbers")
        if args.self_check:
            from dinov3_tpu_torch.train.self_check import run_self_check

            results = run_self_check(setup, put_batch(first, device))
            return {"self_check_failures": sum(not v for v in results.values()),
                    **{f"check/{k}": v for k, v in results.items()},
                    "launches": {k: kern.launches for k, kern in KERNELS.items()}}

        state = setup.state
        result: dict = {"start_iteration": start_iter, **engine}
        if setup.lowp_drift is not None:
            result["lowp_drift"] = setup.lowp_drift
        if latest is not None:
            t_res = time.perf_counter()
            state = ckpt.restore(state)
            result["restore_s"] = time.perf_counter() - t_res
            if state.step != start_iter:
                # a checkpoint can vanish between latest_step() and
                # restore(): realign the data stream with the restored step
                logger.warning("restored step %d != announced latest %d; "
                               "rebuilding the data iterator", state.step, start_iter)
                start_iter = result["start_iteration"] = state.step
                data_iter.close()
                data_iter = build_data_iterator(cfg, B, start_iter=start_iter,
                                                pin=device.type == "cuda")
                first = next(data_iter)
            logger.info("resumed at iteration %d", start_iter)

        logger.info("parameters:\n%s", format_parameter_counts(
            count_parameters(setup.meta.student)))
        recorder = LossRecorder(args.record_losses) if args.record_losses else None
        comparator = LossComparator(args.ref_losses) if args.ref_losses else None
        metric_logger = MetricLogger(
            output_file=f"{out_dir}/training_metrics.json",
            tensorboard_dir=f"{out_dir}/tb" if args.tensorboard else None)
        timer = StepTimer(args.benchmark, total_iters, device)
        period = int(cfg.checkpointing.period)
        eval_period = int(cfg.evaluation.get("eval_period_iterations", 0) or 0)
        anatomy_on = anatomy_wished(cfg)
        plan = setup.telemetry
        ring = plan.init_ring() if plan is not None else None
        reader = plan.reader(start_iteration=start_iter) if plan is not None else None
        evals = []
        nan_streak = 0
        last_loss = math.nan
        saves = []
        compile_sampled = False
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        gc.collect()
        gc.freeze()
        gc.callbacks.append(gc_times)
        frozen = True

        def sched_row(i: int) -> dict:
            s = setup.schedules.at(i)
            return {"lr": s["lr"], "wd": s["weight_decay"], "mom": s["momentum"],
                    "teacher_temp": s["teacher_temp"]}

        def flush_ring(upto: int) -> None:
            """One fetch of the ring; its rows replayed into the meters, the
            recorder and the comparator; then the 3-strike abort, from the
            flushed losses counted on the host across flushes as the
            one-read-a-step path counts them."""
            nonlocal last_loss, nan_streak
            with watchdog.window("metrics_flush", iteration=upto - 1), \
                    tracer.span("metrics_flush", upto - 1):
                its, rows, _ = reader.flush(ring, upto)
            if not len(its):
                return
            loss_col = plan.metric_names.index("total_loss")
            worst = 0
            for j, row_it in enumerate(its):
                if math.isfinite(rows[j][loss_col]):
                    nan_streak = 0
                    continue
                logger.warning("non-finite loss at iteration %d", row_it)
                nan_streak += 1
                worst = max(worst, nan_streak)
            if recorder is not None:
                recorder.record_batch(its, plan.metric_names, rows)
            if comparator is not None:
                comparator.check_batch(its, plan.metric_names, rows)
            metric_logger.consume_flush(plan.metric_names, its, rows, scheds=sched_row)
            last_loss = float(rows[-1][loss_col])
            if memory_on:
                tracer.emit_memory("flush", int(its[-1]))
            if worst > 2:  # the checkpointer is closed on the way out
                raise RuntimeError(f"aborting: {worst} consecutive non-finite losses")

        host_sync_stats(reset=True)
        pending = put_batch(first, device)
        steps = metric_logger.log_every(
            tracer.wrap_iter(data_iter, start_iteration=start_iter), print_freq=10,
            header="Train", n_iterations=total_iters,
            start_iteration=start_iter) if start_iter < total_iters else ()
        for it, raw in steps:
            tracer.profile_step_begin(it)
            with tracer.step_annotation(it):
                with tracer.span("dispatch", it):
                    if plan is not None:  # the metrics stay on the device
                        state, ring = plan.launch_fn(state, ring, pending,
                                                     setup.scalars(it))
                    else:
                        state, step_metrics = setup.launch_fn(state, pending,
                                                              setup.scalars(it))
                with tracer.span("h2d", it):
                    pending = put_batch(raw, device)  # queued behind the step
                if memory_on and not compile_sampled:
                    tracer.emit_memory("compile", it)
                    compile_sampled = True
                if plan is None:
                    with tracer.span("metrics_fetch", it):
                        metrics = step_metrics.read()  # the step's one host read
                    last_loss = metrics["total_loss"]
                    if recorder is not None:
                        recorder.record(it, metrics)
                    if comparator is not None:
                        comparator.check(it, metrics)
                    if not math.isfinite(last_loss):
                        nan_streak += 1
                        logger.warning("non-finite loss at iteration %d", it)
                        if nan_streak > 2:
                            raise RuntimeError(
                                f"aborting: {nan_streak} consecutive non-finite losses")
                    else:
                        nan_streak = 0
                    metric_logger.update(**sched_row(it), **metrics)
                elif it + 1 - reader.cursor >= plan.ring_len or it + 1 >= total_iters:
                    # before the checkpoint, so a save's metrics are recorded
                    flush_ring(it + 1)
            if tracer.profile_step_end(it) is not None:
                if device.type != "cuda":
                    logger.info("trace in %s; the anatomy ledger reads the card's "
                                "kernels, of which a CPU run has none", tracer.trace_path)
                elif anatomy_on:
                    # raises on a trace with no device event
                    result["anatomy"] = summary = emit_step_anatomy(
                        f"{out_dir}/trace", tracer=tracer, cfg=cfg, iteration=it,
                        n_steps=prof[1] - prof[0] + 1)
                    logger.info("step anatomy: %.2f ms/step of device time over %.2f "
                                "ms of wall (ledger: %s/trace/anatomy.json)",
                                summary["device_busy_ms_per_step"],
                                summary["step_wall_ms"]["mean"], out_dir)
            if timer.active(it):
                timer.mark()
            if eval_period and (it + 1) % eval_period == 0:
                with tracer.span("eval", it):
                    evals.append(run_eval(cfg, setup.meta.teacher["backbone"], it, out_dir))
                metric_logger.update(**{k: evals[-1][k] for k in ("knn_top1", "linear_top1")})
                timer.exclude(evals[-1]["seconds"])
            if (it + 1) % period == 0 or it + 1 == total_iters:
                with tracer.span("checkpoint_save", it):
                    saves.append(ckpt.save(it + 1, state))
                timer.exclude(saves[-1]["seconds"])
            if it + 1 >= total_iters:
                break
            tracer.beat(it)
        result["host_sync"] = host_sync_stats()
    finally:
        if frozen:
            gc.callbacks.remove(gc_times)
            gc.unfreeze()
        data_iter.close()
        ckpt.close()
        tracer.close()
        if metric_logger is not None:
            metric_logger.close()
        if recorder is not None:
            recorder.close()

    result.update({
        "final_loss": last_loss, "iterations": state.step, "device": str(device),
        "saves": saves, "evals": evals, "gc": gc_times.summary(),
        "launches": {k: kern.launches for k, kern in KERNELS.items()},
    })
    if tracer.trace_path is not None:
        result["trace"] = tracer.trace_path
    if device.type == "cuda":
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    if recorder is not None:
        logger.info("recorded losses to %s", args.record_losses)
    if comparator is not None:
        logger.info("loss comparison: %s", comparator.summary())
        result["loss_divergences"] = comparator.n_diverged
        result["loss_comparison"] = comparator.summary()
    if timer.n_intervals >= 1:
        result["step_ms"] = [t * 1e3 for t in timer.intervals]
        result["ms_per_step"] = timer.ms_per_step()
        result["img_per_sec"] = timer.img_per_sec(B)
        logger.info("benchmark: %.1f ms/step, %.1f img/s over %d steps",
                    result["ms_per_step"], result["img_per_sec"], timer.n_intervals)
    if args.dump_weights:
        from dinov3_tpu_torch.utils import dump_weights

        result["dump_weights"] = dump_weights(args.dump_weights, state.meta)
    logger.info("training done at iteration %d, final loss %.4f", state.step, last_loss)
    return result


def main(argv=None) -> dict:
    args = get_args_parser().parse_args(argv)
    cfg = load_config(args.config_file or None, overrides=list(args.opts), n_devices=1)
    cfg.train.output_dir = args.output_dir
    setup_job(cfg)
    handlers = setup_logging(args.output_dir)
    try:
        logger.info("config:\n%s", json.dumps(cfg.to_dict(), indent=1, default=str))
        return do_train(cfg, args)
    finally:
        remove_handlers(handlers)


if __name__ == "__main__":
    result = main(sys.argv[1:])
    print(json.dumps(result), flush=True)
    # `--self-check && launch` must fail on a failing model
    if result.get("self_check_failures"):
        sys.exit(1)
