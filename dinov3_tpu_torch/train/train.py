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

Each iteration queues the step on the device with no host read, hands the
next batch (made, and pinned for the card, on a producer thread) to the
device, then reads the step's metrics in one transfer: the host's batch
work overlaps the step's device work. Losses are recorded
(``--record-losses``) and compared (``--ref-losses``) every step; three
non-finite losses in a row abort the run with ``RuntimeError``; a
checkpoint is saved every ``checkpointing.period`` iterations and at the
last. Set-up garbage is collected once and frozen, so the collector's
later passes do not walk it.

Refused at start, each naming the ROADMAP item it waits for: evals inside
the run (M6), distillation, multidistillation, high-res fine-tuning and
pretrained weights (M10), the Gram anchor and its refresh (M12), the
profiler, tensorboard and NaN-debug flags (M11), ``--dump-weights`` (M5),
multi-resolution crop lists (M4) and an elastic ``--resume-topology``
(M12). There is no preemption handler (M12): a signal ends the run, and
the next one resumes from the last finalized checkpoint.
"""

from __future__ import annotations

import argparse
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
from dinov3_tpu_torch.data import SyntheticDataset
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
from dinov3_tpu_torch.telemetry import StepTimer
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

_WAITING_FLAGS = (
    ("profile_steps", "--profile-steps: profiler traces wait (ROADMAP M11)"),
    ("tensorboard", "--tensorboard: tensorboard mirroring waits (ROADMAP M11)"),
    ("debug_nans", "--debug-nans: the non-finite sanitizer waits (ROADMAP M11)"),
    ("dump_weights", "--dump-weights waits (ROADMAP M5)"),
)


def get_args_parser():
    p = argparse.ArgumentParser("DINOv3 pretraining on one card")
    p.add_argument("--config-file", default="", help="run recipe YAML")
    p.add_argument("--output-dir", default=".", help="logs + checkpoints")
    p.add_argument("--no-resume", action="store_true",
                   help="do not resume from the latest checkpoint")
    p.add_argument("--profile-steps", default="",
                   help="'start,stop' profiler window (waits, ROADMAP M11)")
    p.add_argument("--max-iterations", type=int, default=-1,
                   help="hard cap on iterations")
    p.add_argument("--record-losses", default="",
                   help="write per-iteration losses to this JSON-lines file")
    p.add_argument("--ref-losses", default="",
                   help="compare per-iteration losses against a recorded file")
    p.add_argument("--dump-weights", default="",
                   help="dump final params to this .npz (waits, ROADMAP M5)")
    p.add_argument("--benchmark", type=int, default=0, metavar="N",
                   help="time the last N iterations and report img/s")
    p.add_argument("--self-check", action="store_true",
                   help="run two steps on one batch (losses finite, every "
                        "submodule trains, the teacher EMA tracks) and exit")
    p.add_argument("--tensorboard", action="store_true",
                   help="tensorboard events (waits, ROADMAP M11)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first non-finite op (waits, ROADMAP M11)")
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
    for attr, msg in _WAITING_FLAGS:
        if getattr(args, attr):
            raise NotImplementedError(msg)
    eval_period = int(cfg.evaluation.get("eval_period_iterations", 0) or 0)
    s = cfg.student
    waits = [
        (not args.self_check and 0 < eval_period <= total_iters,
         f"evaluation.eval_period_iterations={eval_period} falls inside the "
         f"run's {total_iters} iterations: evals wait (ROADMAP M6)"),
        (bool(cfg.distillation.enabled), "distillation waits (ROADMAP M10)"),
        (bool(cfg.multidistillation.enabled),
         "multidistillation waits (ROADMAP M10)"),
        (bool(cfg.hrft.enabled), "hrft (high-res fine-tuning) waits (ROADMAP M10)"),
        (bool(s.get("pretrained_weights") or s.get("resume_from_teacher_chkpt")),
         "pretrained student weights wait (ROADMAP M10)"),
        (bool(cfg.gram.get("ckpt")) or bool(cfg.gram.use_loss and cfg.gram.rep_update
                                            and not cfg.gram.ema_teacher),
         "the Gram anchor and its refresh wait (ROADMAP M12)"),
        (isinstance(cfg.crops.global_crops_size, (list, tuple)),
         "crop-size lists (multi-resolution recipes) wait (ROADMAP M4)"),
    ]
    for refused, msg in waits:
        if refused:
            raise NotImplementedError(msg)


def pin_batch(batch: dict) -> dict:
    """numpy batch -> CPU tensors in pinned memory (for the card's copy)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            for k, v in batch.items()}


def build_data_iterator(cfg, batch_size: int, start_iter: int = 0,
                        pin: bool = False):
    """Host batches on a producer thread, starting at batch ``start_iter``
    (resume). Close it to stop the thread. ``pin``: hand the synthetic
    batches over in pinned memory."""
    backend = cfg.data.backend
    if backend == "synthetic":
        source = SyntheticDataset(cfg, batch_size, seed=cfg.train.seed,
                                  advance=start_iter)
        return BackgroundIterator(source, depth=int(cfg.data.get("prefetch", 2) or 2),
                                  transform=pin_batch if pin else None)
    if backend in ("folder", "imagenet"):
        from dinov3_tpu_torch.data.pipeline import make_train_pipeline

        return make_train_pipeline(cfg, batch_size,
                                   sampler_advance=start_iter * batch_size)
    raise ValueError(f"unknown data backend {backend!r}")


def resolved_engine(setup) -> dict:
    """What the step resolved from the config: the target engine
    (streaming or materialized), the centering, the K-tile cap, the
    student's activation checkpointing and the accumulation steps."""
    meta = setup.meta
    return {"targets": "streaming" if meta.streaming_targets else "materialized",
            "centering": meta.centering, "k_tile": meta.loss_k_tile,
            "remat": meta.student["backbone"].remat,
            "accum_steps": int(setup.cfg.optim.get("accum_steps", 1) or 1)}


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
    recorder = None
    gc_times = _GcTimes()
    frozen = False
    try:
        first = next(data_iter)
        t0 = time.perf_counter()
        setup = build_train_setup(cfg, first, device=device, seed=cfg.train.seed)
        logger.info("device %s | batch %d | setup %.1f s", device, B,
                    time.perf_counter() - t0)
        engine = resolved_engine(setup)
        logger.info("targets %s (%s, k_tile %d) | remat %s | accum_steps %d",
                    engine["targets"], engine["centering"], engine["k_tile"],
                    engine["remat"], engine["accum_steps"])
        if args.self_check:
            from dinov3_tpu_torch.train.self_check import run_self_check

            results = run_self_check(setup, put_batch(first, device))
            return {"self_check_failures": sum(not v for v in results.values()),
                    **{f"check/{k}": v for k, v in results.items()},
                    "launches": {k: kern.launches for k, kern in KERNELS.items()}}

        state = setup.state
        result: dict = {"start_iteration": start_iter, **engine}
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
        metric_logger = MetricLogger(output_file=f"{out_dir}/training_metrics.json")
        timer = StepTimer(args.benchmark, total_iters, device)
        period = int(cfg.checkpointing.period)
        nan_streak = 0
        last_loss = math.nan
        saves = []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        gc.collect()
        gc.freeze()
        gc.callbacks.append(gc_times)
        frozen = True

        pending = put_batch(first, device)
        steps = metric_logger.log_every(
            data_iter, print_freq=10, header="Train", n_iterations=total_iters,
            start_iteration=start_iter) if start_iter < total_iters else ()
        for it, raw in steps:
            state, step_metrics = setup.launch_fn(state, pending, setup.scalars(it))
            pending = put_batch(raw, device)  # queued behind the step
            metrics = step_metrics.read()     # the step's one host read
            last_loss = metrics["total_loss"]
            if recorder is not None:
                recorder.record(it, metrics)
            if comparator is not None:
                comparator.check(it, metrics)
            if not math.isfinite(last_loss):
                nan_streak += 1
                logger.warning("non-finite loss at iteration %d", it)
                if nan_streak > 2:  # the checkpointer is closed on the way out
                    raise RuntimeError(
                        f"aborting: {nan_streak} consecutive non-finite losses")
            else:
                nan_streak = 0
            sched = setup.schedules.at(it)
            metric_logger.update(lr=sched["lr"], wd=sched["weight_decay"],
                                 mom=sched["momentum"],
                                 teacher_temp=sched["teacher_temp"], **metrics)
            if timer.active(it):
                timer.mark()
            if (it + 1) % period == 0 or it + 1 == total_iters:
                saves.append(ckpt.save(it + 1, state))
                timer.exclude(saves[-1]["seconds"])
            if it + 1 >= total_iters:
                break
    finally:
        if frozen:
            gc.callbacks.remove(gc_times)
            gc.unfreeze()
        data_iter.close()
        ckpt.close()
        if recorder is not None:
            recorder.close()

    result.update({
        "final_loss": last_loss, "iterations": state.step, "device": str(device),
        "saves": saves, "gc": gc_times.summary(),
        "launches": {k: kern.launches for k, kern in KERNELS.items()},
    })
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
