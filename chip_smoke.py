#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dinov3_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``dinov3_tpu_torch/csrc/``
(into ``build/kernels/``, one ``nvcc`` per source, all in parallel) and
drives the port's serve path and its training step on the card:

A. environment: torch, CUDA and nvcc versions, the card's name and power
   limit, the kernel build time;
B. each kernel against its plain PyTorch version on the card, at the
   serve path's shapes, the training step's shapes and edge shapes, with
   its time (warm, and cold: rotating over copies of the inputs larger
   than the 50 MB L2 cache), the plain version's time, one PyTorch
   library call's time (a yardstick the port never calls) and the least
   time the card could take (``bound_ms``); K1's tile schedule kernel
   against its plain twin, bitwise, with the share of key tiles visited;
C. the serve path at ViT-L/16 full width (``configs/train/vitl16_im1k.yaml``:
   24 blocks, width 1024, packs of 4 x 2050 tokens) with seeded random
   weights: 64 ragged requests through ``build_serve_engine`` → flush;
   one finite response per request, packed features against per-image
   features, and the launch counts of both kernels (24 flash-attention
   and 50 LayerNorm launches a pack);
D. one pack through a 2-block model at ViT-L width on the card (kernels)
   and on the CPU (plain versions), same weights, compared;
B'. the backward kernels K2, K3 (flash attention dQ, dK/dV; K3 walking
   the forward's tile schedule, with the share of q tiles it walks) and
   K5 (LayerNorm backward, at a student block's norm and at all packed
   rows) against their plain versions at the training step's shapes and
   at edge shapes, each run twice for bitwise repeatability, with times,
   bounds and library yardsticks;
E. the SSL training step at ViT-L/16 full width and depth
   (``configs/train/vitl16_im1k.yaml`` at 32 images, materialized
   targets) through ``build_train_setup`` and its ``step_fn``: a warm-up
   step, then 5 timed steps with every loss finite, ms per step, img/s,
   peak memory and the launches of K1-K5 pinned per step, the shapes K5
   runs at in one step, and one step profiled by kernel class;
F. one training step of a 2-block ViT-L-width model (4096 prototypes,
   4 images, LayerScale 1) on the card and on the CPU from the same
   weights, batch and drop-path plan: loss terms, gradient norms and the
   updated student compared;
G. the pretraining CLI (``python -m dinov3_tpu_torch.train.train``) at
   ViT-L/16 full width cut to 4 blocks (``CLI_DEPTH``: phases H7 and K1 run the
   CLI at full depth), B=32, synthetic data, each run a child process
   with a time limit: 12 iterations, the last 8 timed by ``--benchmark``,
   a save every 4 (its step-4 checkpoint is phase I's and J4's); from
   that save, with a torn ``tmp.5/`` and an unfinalized ``5/`` planted, a
   resume in a new process to 8, its losses compared with the
   uninterrupted run's (``--ref-losses``), its final teacher with that
   run's, and its ``--dump-weights`` with its own last checkpoint;
   ``--self-check``; and 2 steps of the image-folder pipeline on texture
   images. Each child's K1-K5 launches are checked against
   ``CLI_STEP_LAUNCHES`` per step; the checkpoints are deleted after.

H. the recipe as written (``configs/train/vitl16_im1k.yaml`` with only
   ``data.backend=synthetic``: B=64, streaming Sinkhorn targets, K-tile
   8192) through ``build_train_setup`` + ``step_fn`` (H1: 5 timed steps,
   every loss finite, K1-K5 launches pinned, one profiled step), then the
   same weights, batch and plans with materialized targets (H2), under
   ``blocks`` and ``full`` activation checkpointing (H3), with
   ``optim.accum_steps=2`` (H4), softmax centering with bf16 targets (H5),
   the phase-F card-vs-CPU step with streaming targets, ``blocks`` remat
   and two microbatches (H6), and one trainer CLI run of the recipe (H7).
I. the evaluation path at ViT-L/16: feature extraction with seeded
   weights over synthetic 256 px images through the eval transform at 224
   px, batches of 256 (I1: img/s apart from the host pipeline, peak
   memory, K1 x24 and K4 x49 launches a batch pinned, K1 and K4 timed at
   the eval shapes); a 2-block model's features and intermediate layers
   on the card against the CPU (I2); k-NN at k = 10, 20 and one epoch of
   the 8-lr probe sweep at ImageNet-1k's sizes (1,281,167 / 50,000 rows
   of 1024, 1000 classes) on seeded class-structured features, and a
   20k / 5k subset on the card against the CPU (I3); ``python -m
   dinov3_tpu_torch.evals`` on phase G's step-4 checkpoint in a child
   process, the teacher it restores compared bitwise (I4); and evals
   inside a trainer CLI run at B=32, their launches on top of the steps'
   and the step times within phase G's band (I5).
J. the serving plane at ViT-L/16 (run before I, which deletes phase G's
   checkpoint), through ``dinov3_tpu_torch/serve/bench.py``'s functions
   on the default ``serve:`` block: the packed engine and both oracles
   over the same 128 mixed_ragged requests after a disjoint warm-up draw
   (J1: sustained img/s, a rated Poisson replay at 0.7 x the packed rate
   with exact p50/p99 overall and per SLO class and the observer's
   histograms within a bucket of them, packed features within 2^-5 of
   per-image ones, compile counts, one fetch and one synchronizing call
   a pack, K1/K4 launches, device-busy profiles); int8 against bf16 (J2:
   resident bytes, drift, best of 3 drains); the fleet with an int8 fast
   lane derived from the warm draw and the cache at a hit rate of 0.5,
   every hit bitwise its miss (J3); ``build_serve_engine(ckpt_dir=...)``
   on phase G's checkpoint, ``serve.continuous_packing=false`` and the
   bench CLI's ``--smoke`` as a child process (J4); K1 at the oracle's
   dense shapes, N = 37, 193, 1025 (J5).
K. the ViT-g/14 web-shard recipe (``configs/train/vitg14_webshards.yaml``:
   40 blocks, 1536 wide, 24 heads of 64, patch 14, 4 registers, SwiGLU,
   131,072 prototypes, ``blocks`` remat; one-card override
   ``parallel.fsdp=1``): K1-K5 against their plain versions at its shapes
   (K0: N = 261 with and without ids, N = 54, D = 1536); the trainer CLI at
   full width cut to 20 of its 40 blocks (``VITG_CLI_DEPTH``, the time
   limit), B=16, from 320 seeded JPEGs in web shards it
   writes, 11 iterations (4 timed: ms a step, img/s, peak memory, launches
   pinned a step; the resumes in a new process are phase G's and M3's)
   (K1); the options the slice
   lifted as card-vs-CPU steps of a 2-block model at
   ViT-g width: the two-pass student with ``rng.plan=false`` and RoPE
   coordinate augmentation, and RoPE augmentation on a crop-size list's
   second entry (K2); a SwiGLU ViT-g state_dict in
   Meta's names (2 blocks) served from its file by the packed engine on
   the card against the CPU (K3). K1's CLI run takes 11 iterations: 3-5
   under ``--profile-steps`` (L1, below), 7-10 timed by ``--benchmark``.
L. the trainer's telemetry and the fp8 / int8 arms: the step anatomy of
   K1's profiled ViT-g iterations from the ``anatomy.json`` the trainer
   wrote (per step: device ms by category, busy, wall, idle share,
   backward; the top 10 kernels; held against the trace: each step's
   categories summing to the union of its device intervals within 1 %,
   the steps holding the trace's device time with under 1 % outside
   them, every step's K1-K5 kernel events = the pins) (L1); the
   ViT-L/16 recipe as written in bf16, fp8 and int8
   (``train.low_precision.arm``), 5 timed steps each with launches pinned,
   every loss finite, the peak and the drift probe against
   ``divergence_tol``, and a profiled window of 2 steps for bf16 and fp8,
   held as L1's (L2);
   ``lowp_matmul``'s GEMMs at the recipe's ``qkv`` and ``fc2`` shapes
   against their plain versions (int8 bitwise, fp8 within 2^-10 of the
   absolute product sum; dx, dw within the bf16 bound), the student's
   gradients of a 2-block fp8 and int8 forward on the card against a
   float64 straight-through reference within 2^-7, two planted wrong
   backwards outside it, and a 2-block fp8 and int8 step card against
   CPU (L3); the CLI at 4 blocks over 8
   iterations with ``telemetry.flush_every=4`` under ``--debug-nans`` and
   ``--tensorboard`` (every loss recorded, 2 metrics fetches), and a NaN
   planted in a block's GELU, which ``--debug-nans`` names (L4).
M. the Gram anchor at ViT-7B width (``configs/train/vit7b16_gram_anchor.yaml``:
   4096 wide, 32 heads of 128, SwiGLU 64 at ratio 3, 4 registers, 262,144 /
   98,304 prototypes, B=16, 512 px Gram teacher crops, ``gram.img_level``;
   one-card overrides ``parallel.fsdp=1 data.backend=synthetic``): K1-K5
   against their plain versions at head_dim 128 and D = 4096 (M0: the
   student's packed rows with ids, the teacher's N = 261 and the Gram
   teacher's N = 1029 without, the LayerNorms' general path); the step
   through ``build_train_setup`` + ``step_fn`` at full width cut to
   ``GRAM_DEPTH`` blocks (3 timed steps: ms, img/s, peak, launches pinned a
   step, every loss finite; one step profiled by kernel class; the Gram
   branch frozen, then refreshed from the teacher) (M1); a 2-block step
   with the Gram loss on the card against the CPU (M2, in a process of its
   own beside M3); the trainer CLI at 1 block with small heads: a fresh
   run anchored by ``gram.ckpt`` to a checkpoint written here, a refresh
   after iteration 2, and a resume from its step-2 save, past torn saves,
   in a new process, held by ``--ref-losses`` and bitwise (M3).
N. distillation at ViT-7B depth (``configs/train/vitl16_distilled.yaml``:
   a ViT-L/16 student at B=16, 262,144 / 98,304 prototypes, distilling from
   ``configs/train/vit7b16_pretrain.yaml``'s ViT-7B/16 at its 40 blocks,
   drawn on the card; one-card overrides ``parallel.fsdp=1
   data.backend=synthetic``): K1-K5 against their plain versions at this
   path's shapes (the student's packed rows at B=16, the in-step teacher's
   [32 x 32, 261, 128], the teacher engine's packs [4 x 32, 522, 128] with
   ids, K4 at D = 1024 and 4096); the step through ``build_train_setup`` +
   ``step_fn`` with the teacher in the step (2 warm-up and 5 timed steps:
   set-up s, ms, img/s, peak, launches pinned a step, every loss finite,
   the teacher unchanged; one step profiled by kernel class) (N0); in the
   same process, the shared ``TeacherServer`` built from the state's
   teacher (cast to bf16 on the card): its planes against the in-step
   teacher's features, a replay with no forward and the same bits, the
   engine's img/s and device-busy profile, 3 serve-arm steps with
   launches pinned and one profiled, a second student's config getting
   the same server (N1); a 2-block ViT-L student from a 1-block ViT-7B-width teacher
   on the card against the CPU (N2, in a process of its own beside N3);
   the trainer CLI on the serve arm with its student cut to 4 blocks and a
   teacher checkpoint written here: 4 iterations, a resume from the step-2
   save in a new process held by ``--ref-losses`` and bitwise, and
   ``--self-check`` reporting the frozen teacher (N3).
O. the ConvNeXt family and the full-depth ViT-7B eval: the distilled
   recipe with a ConvNeXt-L/16 student (``student.arch=convnext_large`` on
   the command line; depths 3, 3, 27, 3, widths 192 to 1536) and its
   40-block ViT-7B/16 teacher drawn on the card: K4 and K5 against their
   plain versions at each stage's rows of the 2B = 32 global crops (C =
   192, 384, 768, 1536) and K4 on the final norm's rows; the step through
   ``build_train_setup`` + ``step_fn`` (a warm-up and 5 timed steps:
   set-up s, ms, img/s, peak, K1-K5 launches pinned a step, every loss
   finite; one step profiled by kernel class, the convolutions and the
   copies as classes of their own) (O0); a step at ConvNeXt-L widths with
   one block a stage, 4096 prototypes and B=2, on the card and on the CPU,
   with its EMA ConvNeXt teacher and drop path at rate 0.2, and from a
   1-block ViT-7B-width teacher, and the SSL state's checkpoint read back by ``build_model_for_eval``
   (O1, each arm in a process of its own beside O3); eval extraction at
   B=256, 224 px of ConvNeXt-L and of ``vit7b16_pretrain.yaml``'s
   ViT-7B/16 at its 40 blocks, both drawn on the card by
   ``build_model_for_eval`` (set-up s, img/s, the share of the bf16 cap
   from counted operations, launches pinned a batch, a batch run twice
   bit for bit), K1 and K4 at the
   7B's eval shapes (O2); the trainer CLI
   on O0's recipe at full depth with the small teacher of N3 (4
   iterations, a save at 4, ``--dump-weights``): its launches, its
   start-up split by stage, and ``build_model_for_eval`` on its checkpoint
   against the dump, bit for bit (O3).

Prints each phase's seconds, the kernel table as one JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without a card it exits non-zero
before doing anything.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
BF16_TC_FLOP_S = 989e12     # H100 SXM dense bf16 tensor-core peak
FP32_FLOP_S = 67e12         # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20     # H100 L2 cache
# the mixed_ragged traffic bands of dinov3_tpu_torch/serve/bench.py:
# (probability, (min_px, max_px)), H and W drawn on the patch grid
MIXED_RAGGED = [(0.70, (96, 256)), (0.20, (208, 320)), (0.10, (336, 512))]
# images a step in the recipe as written (configs/train/vitl16_im1k.yaml)
RECIPE_B = 64
# bf16 tolerances (see each use)
FLASH_BF16_TOL = 2e-2
N_REQUESTS = 64


class SmokeFailure(RuntimeError):
    pass


def _kernels() -> dict:
    from dinov3_tpu_torch.ops.flash_attention import (
        FLASH_BWD_DKV,
        FLASH_BWD_DQ,
        FLASH_FWD,
    )
    from dinov3_tpu_torch.ops.fused_norm import LAYERNORM_BWD, LAYERNORM_FWD

    return {"K1": FLASH_FWD, "K2": FLASH_BWD_DQ, "K3": FLASH_BWD_DKV,
            "K4": LAYERNORM_FWD, "K5": LAYERNORM_BWD}


KERNELS: dict = {}  # filled by main(): the CudaKernel of K1-K5


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def make_mix(rng, bands, n: int, grid: int) -> list:
    """n seeded [H, W, 3] float32 images from the banded distribution."""
    from dinov3_tpu_torch.serve.bench import make_mix as draw

    return draw(rng, bands, n, grid)


def cold_ms(fn, inputs: list, iters: int = 20) -> float:
    """Mean device time of fn(*inputs[i]) over iters launches, rotating
    over the copies in inputs: with copies that together exceed the L2
    cache, each launch finds its inputs in device memory."""
    sets = itertools.cycle(inputs)
    return cuda_ms(lambda: fn(*next(sets)), iters)


def copies_past_l2(nbytes: int) -> int:
    """Copies of a call's inputs that together hold twice the L2 cache."""
    return max(2, -(-2 * L2_BYTES // max(nbytes, 1)) + 1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters launches, by CUDA events. A
    spin kernel holds the stream while the host enqueues the launches, so
    they run back to back and a call whose Python wrapper takes longer
    than its kernel is timed by its kernel, not by its wrapper."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    host_s = []  # enqueue time of one call, the slowest of three
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host_s.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    # at most 2e9 cycles a second: the spin outlasts four times the enqueueing
    torch.cuda._sleep(int(min(4 * iters * max(host_s) + 2e-3, 2.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------- phase A

def phase_a():
    import torch

    from dinov3_tpu_torch.ops._cuda import _nvcc, build_kernels

    print(f"[A] python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  card {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"[A] nvcc: {nvcc[-1]}")
    print(f"[A] nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    built = build_kernels(list(KERNELS.values()))
    print(f"[A] kernel build {time.perf_counter() - t0:.1f} s wall "
          f"(rebuilt: {sorted(built) or 'none, cached'})")
    for k in KERNELS.values():
        print(f"[A] {k.name}: " + "; ".join(ptxas_summary(k.build_log)))


def _entry_name(mangled: str) -> str:
    """The kernel's name in a mangled symbol (the last length-prefixed
    name that starts with flash or layernorm), with its template argument."""
    found = mangled
    for m in re.finditer(r"(\d+)((?:flash|layernorm)\w*)", mangled):
        digits, rest = m.groups()
        # the longest suffix of the digits that is the name's length
        n = next((int(digits[i:]) for i in range(len(digits))
                  if int(digits[i:]) <= len(rest)), None)
        if n is not None:
            t = re.match(r"ILi(\d+)E", rest[n:])
            found = rest[:n] + (f"<{t.group(1)}>" if t else "")
    return found


def ptxas_summary(log: str) -> list[str]:
    """'entry: R registers, S bytes spilled' for each kernel entry of an
    ``nvcc -Xptxas -v`` log, the entry named by its function and template
    argument (``flash_bwd_dq_wgmma``, ``flash_fwd_bf16<128>``)."""
    out, entry, spill = [], "?", "?"
    for ln in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", ln):
            entry = _entry_name(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores", ln):
            spill = m.group(1)
        elif m := re.search(r"Used (\d+) registers", ln):
            out.append(f"{entry}: {m.group(1)} registers, {spill} bytes spilled")
    return out


# ---------------------------------------------------------------- phase B

def serve_pack_seg(cfg, seed: int = 0):
    """The seg plane [R, N] int32 of the first pack of a seeded
    mixed_ragged stream, from the port's own batcher."""
    from dinov3_tpu_torch.serve import ContinuousBatcher, ServeRequest
    from dinov3_tpu_torch.serve import serve_layout_from_cfg

    layout = serve_layout_from_cfg(cfg)
    batcher = ContinuousBatcher(layout)
    rng = np.random.default_rng(seed)
    for i, im in enumerate(make_mix(rng, MIXED_RAGGED, N_REQUESTS,
                                    layout.patch_size)):
        batcher.admit(ServeRequest(request_id=i, image=im))
    return batcher.next_pack().planes["seg"].copy()


def seg_pairs(seg) -> int:
    """Token pairs that meet: the sum over rows and segments of count^2."""
    return sum(int(c) ** 2 for row in seg
               for c in np.unique(row, return_counts=True)[1])


def bound(nbytes: float, flops: float, flop_s: float) -> tuple[float, str]:
    """Least time in ms: bytes over the memory rate or operations over the
    peak rate, whichever is larger, and which one it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flop_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def flash_bound(seg, B, N, H, D) -> tuple[float, str]:
    """Least time for attention on these inputs: each input byte read
    once and each output written once, against the tensor-core work the
    segments need (a token only meets its own segment)."""
    nbytes = 4 * B * N * H * D * 2 + B * H * N * 4
    if seg is None:
        pairs = B * N * N
    else:
        nbytes += seg.size * 4
        pairs = seg_pairs(seg)
    return bound(nbytes, 4 * D * H * pairs, BF16_TC_FLOP_S)


def check_flash(q, k, v, seg, label, time_it=False) -> dict:
    """K1 against attention_plain (O within FLASH_BF16_TOL in bf16, 2e-5 in
    fp32; LSE within 10x that), run twice for the same bits. Timed: warm
    and cold ms, plain and library ms, the bound, and the share of key
    tiles the schedule visits (1 without segment ids)."""
    import torch
    import torch.nn.functional as F

    from dinov3_tpu_torch.ops.flash_attention import (
        FWD_TILES,
        attention_plain,
        flash_attention,
        flash_tile_schedule,
    )

    out, lse = flash_attention(q, k, v, seg)
    again, _ = flash_attention(q, k, v, seg)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"K1 {label}: two runs differ")
    want, want_lse = attention_plain(q, k, v, seg)
    err = (out.float() - want.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    tol = FLASH_BF16_TOL if q.dtype == torch.bfloat16 else 2e-5
    print(f"[B] K1 {label}: max|O - plain| {err:.3e} (tol {tol:g}), "
          f"max|LSE - plain| {lse_err:.3e}")
    check(np.isfinite(err) and err <= tol, f"K1 {label} disagrees: {err}")
    check(lse_err <= 10 * tol, f"K1 {label} LSE disagrees: {lse_err}")
    row = {"max_abs_err": err}
    if time_it:
        B, N, H, D = q.shape
        row["visited_share"] = 1.0
        if seg is not None:
            tiles, counts = flash_tile_schedule(seg, *FWD_TILES[q.dtype])
            row["visited_share"] = counts.sum().item() / tiles.numel()
        row["ms"] = cuda_ms(lambda: flash_attention(q, k, v, seg), 20)
        # cold: copies of q, k and the tensor v views, past the L2 cache
        vbase = v if v._base is None else v._base
        nbytes = (q.numel() + k.numel() + vbase.numel()) * q.element_size()
        sets = [(q.clone(), k.clone(),
                 v if i == 0 else vbase.clone().as_strided(v.shape, v.stride(),
                                                           v.storage_offset()))
                for i in range(copies_past_l2(nbytes))]
        row["cold_ms"] = cold_ms(lambda a, b, c: flash_attention(a, b, c, seg), sets)
        del sets
        row["plain_ms"] = cuda_ms(lambda: attention_plain(q, k, v, seg), 3, 1)
        # yardstick: one library call on the same inputs, with the
        # block-diagonal mask as a boolean [B, 1, N, N] plane
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None if seg is None else (seg[:, None, :, None]
                                         == seg[:, None, None, :])
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
            10)
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - want.float()).abs().max().item()
        row["bound_ms"], row["bound_by"] = flash_bound(
            None if seg is None else seg.cpu().numpy(), B, N, H, D)
        print(f"[B] K1 {label}: kernel {row['ms']:.4f} ms (cold "
              f"{row['cold_ms']:.4f})  plain {row['plain_ms']:.4f} ms  library "
              f"{row['library_ms']:.4f} ms (library max err {lib_err:.3e})  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  key tiles visited "
              f"{row['visited_share']:.4f}")
    return row


def check_layernorm(x, s, b, label, time_it=False) -> dict:
    import torch
    import torch.nn.functional as F

    from dinov3_tpu_torch.ops.fused_norm import fused_layernorm, layernorm_plain

    got = fused_layernorm(x, s, b)
    torch.cuda.synchronize()
    want = layernorm_plain(x, s, b)
    err = (got.float() - want.float()).abs().max().item()
    # bf16: both sides compute in fp32 and round once, so at most one
    # bf16 ulp of the output (2^-7 of its magnitude); fp32: 1e-5
    mag = want.float().abs().max().item()
    tol = 2.0 ** -7 * max(mag, 1.0) if x.dtype == torch.bfloat16 else 1e-5
    print(f"[B] K4 {label}: max|y - plain| {err:.3e} (tol {tol:.3e})")
    check(np.isfinite(err) and err <= tol, f"K4 {label} disagrees: {err}")
    row = {"max_abs_err": err}
    if time_it:
        R, D = x.shape
        row["ms"] = cuda_ms(lambda: fused_layernorm(x, s, b), 50)
        sets = [(x.clone(),) for _ in range(copies_past_l2(x.numel() * x.element_size()))]
        row["cold_ms"] = cold_ms(lambda t: fused_layernorm(t, s, b), sets, 50)
        del sets
        row["plain_ms"] = cuda_ms(lambda: layernorm_plain(x, s, b), 20)
        # F.layer_norm takes scale and bias in x's dtype
        sl, bl = s.to(x.dtype), b.to(x.dtype)
        row["library_ms"] = cuda_ms(
            lambda: F.layer_norm(x, (D,), sl, bl, eps=1e-6), 50)
        nbytes = 2 * R * D * x.element_size() + 2 * D * s.element_size()
        # sums, centring, square, scale, shift: ~8 operations an element
        row["bound_ms"], row["bound_by"] = bound(nbytes, 8 * R * D, FP32_FLOP_S)
        print(f"[B] K4 {label}: kernel {row['ms']:.4f} ms (cold "
              f"{row['cold_ms']:.4f})  plain "
              f"{row['plain_ms']:.4f} ms  library {row['library_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_b(cfg) -> dict:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    # K1 at the serve shape: q, k, v of one pack as the qkv projection
    # lays them out ([4, 2050, 3 * 1024] bf16, v a strided view)
    seg = torch.from_numpy(serve_pack_seg(cfg)).to(dev)
    R, N = seg.shape
    H, D = 16, 64
    qkv = randn(R, N, 3 * H * D)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(R, N, H, D)
               for i in range(3))
    k1 = check_flash(q.contiguous(), k.contiguous(), v, seg,
                     f"serve pack [{R}x{H}, {N}, {D}] bf16 seg", time_it=True)
    check_flash(q.contiguous(), k.contiguous(), v.contiguous(), None,
                f"[{R}x{H}, {N}, {D}] bf16 no seg", time_it=True)
    check_flash(randn(4, 201, 6, 64), randn(4, 201, 6, 64),
                randn(4, 201, 6, 64), None, "ragged N=201 [4x6, 201, 64] bf16")
    s128 = torch.zeros(2, 1029, dtype=torch.int32, device=dev)
    s128[:, 600:] = 1
    check_flash(randn(2, 1029, 8, 128), randn(2, 1029, 8, 128),
                randn(2, 1029, 8, 128), s128, "head_dim 128 [2x8, 1029, 128] bf16 seg")
    check_flash(randn(2, 333, 4, 64, dtype=torch.float32),
                randn(2, 333, 4, 64, dtype=torch.float32),
                randn(2, 333, 4, 64, dtype=torch.float32), None,
                "[2x4, 333, 64] fp32")

    # K1 at the training step's shapes, B=32 (phase E) and the recipe's
    # B=64 (phase H): the teacher's [2B x 16, 197, 64] with no segments,
    # one student block's [keep x 16, 197, 64] with the packed layout's ids
    # after a drop-path subset; v a view of qkv
    train = {}
    for key, rows, tseg in (("teacher", 2 * TRAIN_B, None),
                            ("student", None, train_attention_seg()),
                            ("recipe teacher", 2 * RECIPE_B, None),
                            ("recipe student", None, train_attention_seg(RECIPE_B))):
        tseg = None if tseg is None else torch.from_numpy(tseg).to(dev)
        rows = rows if tseg is None else tseg.shape[0]
        tqkv = randn(rows, 197, 3 * H * D)
        tq, tk, tv = (tqkv[..., i * H * D:(i + 1) * H * D].reshape(rows, 197, H, D)
                      for i in range(3))
        train[key] = check_flash(
            tq.contiguous(), tk.contiguous(), tv, tseg,
            f"train {key} [{rows}x{H}, 197, {D}] bf16 {'no seg' if tseg is None else 'seg'}",
            time_it=True)
        del tqkv, tq, tk, tv
    k1["train_shapes"] = train
    check_schedule(seg)

    # K4 at the serve shape: [4 * 2050, 1024] bf16 with bf16 serving params
    x = randn(R * N, 1024) * 3 + 1
    s, b = randn(1024) * 0.5 + 1, randn(1024)
    k4 = check_layernorm(x, s, b, f"serve plane [{R * N}, 1024] bf16",
                         time_it=True)
    # K4 at a student block's norm in the training step: [keep x 197,
    # 1024] bf16 rows with the fp32 master scale and bias, at B=32 and at
    # the recipe's B=64
    k4["train_shapes"] = {}
    for key, batch in (("student", TRAIN_B), ("recipe student", RECIPE_B)):
        rows = train_attention_seg(batch).shape[0] * 197
        k4["train_shapes"][key] = check_layernorm(
            randn(rows, 1024) * 3 + 1, s.float(), b.float(),
            f"train {key} block [{rows}, 1024] bf16, fp32 params", time_it=True)
    check_layernorm(randn(1003, 1024), s, b, "ragged rows [1003, 1024] bf16")
    check_layernorm(randn(50, 2048), s.repeat(2), b.repeat(2), "[50, 2048] bf16")
    check_layernorm(randn(9, 4096), s.repeat(4), b.repeat(4),
                    "[9, 4096] bf16 (general path)")
    check_layernorm(randn(77, 1024, dtype=torch.float32),
                    s.float(), b.float(), "[77, 1024] fp32")
    return {"K1": k1, "K4": k4}


def check_schedule(serve_seg) -> None:
    """K1's schedule kernel against its plain twin, bitwise, on the serve
    pack, the training seg plane, and shuffled ids with negative ones and
    an all-pad row; prints the share of key tiles each visits."""
    import torch

    from dinov3_tpu_torch.ops.flash_attention import (
        FWD_TILES,
        flash_tile_schedule,
        flash_tile_schedule_plain,
    )

    rng = np.random.default_rng(4)
    shuffled = rng.integers(-3, 40, (6, 1000)).astype(np.int32)
    shuffled[2] = -1
    planes = (("serve pack", serve_seg.cpu()),
              ("train plane", torch.from_numpy(train_attention_seg())),
              ("shuffled ids, negatives, an all-pad row", torch.from_numpy(shuffled)))
    for label, seg in planes:
        for blocks in sorted(set(FWD_TILES.values())):
            got = flash_tile_schedule(seg.to("cuda"), *blocks)
            torch.cuda.synchronize()
            want = flash_tile_schedule_plain(seg, *blocks)
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            print(f"[B] K1 schedule {label} {tuple(seg.shape)} tiles {blocks}: "
                  f"bitwise {same}, key tiles visited "
                  f"{want[1].sum().item() / want[0].numel():.4f}")
            check(same, f"K1 schedule {label} {blocks} differs from its plain twin")


# ---------------------------------------------------------------- phase C

def serve_requests(engine, images, first_id: int = 0) -> dict:
    for i, im in enumerate(images):
        engine.submit(im, request_id=first_id + i)
    out = []
    while engine.queue_len:
        out.extend(engine.flush())
    return {r.request_id: r for r in out}


def phase_c(cfg) -> tuple[dict, int]:
    import torch

    from dinov3_tpu_torch.serve import build_serve_engine

    t0 = time.perf_counter()
    engine = build_serve_engine(cfg, device="cuda", seed=0)
    model = engine.model
    L = engine.layout
    print(f"[C] ViT-L/16 serving model: {model.n_blocks} blocks, width "
          f"{model.embed_dim}, {model.num_heads} heads, packs of {L.rows} x "
          f"{L.row_tokens} tokens, {sum(p.numel() for p in model.parameters())}"
          f" bf16 parameters; built in {time.perf_counter() - t0:.1f} s")
    check(model.n_blocks == 24 and model.embed_dim == 1024
          and L.rows == 4 and L.row_tokens == 2050, "not the ViT-L/16 slice")
    rng = np.random.default_rng(1)
    images = make_mix(rng, MIXED_RAGGED, N_REQUESTS, L.patch_size)
    # warm-up pack (library handles, allocator) outside the counted run
    serve_requests(engine, images[:4], first_id=10_000)
    torch.cuda.synchronize()

    reset_counts()
    packs0 = engine.packs_run
    t0 = time.perf_counter()
    responses = serve_requests(engine, images)
    wall = time.perf_counter() - t0
    launches = read_counts()
    packs = engine.packs_run - packs0
    print(f"[C] served {len(responses)} requests in {packs} packs: "
          f"{wall * 1e3:.1f} ms, {N_REQUESTS / wall:.2f} img/s, "
          f"{wall * 1e3 / packs:.2f} ms per pack, mean pad waste "
          f"{engine.mean_pad_waste:.3f}; launches {launches}")
    check(sorted(responses) == list(range(N_REQUESTS)),
          "not one response per request")
    for r in responses.values():
        check(r.cls_feature.shape == (1024,)
              and r.pooled_patch_feature.shape == (1024,)
              and np.isfinite(r.cls_feature).all()
              and np.isfinite(r.pooled_patch_feature).all(),
              f"request {r.request_id}: bad features")
    want = {"K1": 24 * packs, "K2": 0, "K3": 0, "K4": 50 * packs, "K5": 0}
    check(launches == want, f"serve launches {launches} != {want}")

    # packed vs per-image features through the model's own forward on the
    # card. Tolerance 2^-5 of the feature magnitude (about 8 bf16 ulps):
    # both run in bf16, but the packed row and the single image go through
    # other matmul shapes and other key-tile boundaries in K1. At the
    # recipe's LayerScale 1e-5 the blocks' branches fall below the bf16
    # resolution of the residual stream, so this checks the packing,
    # prefix injection, norms and extraction; phase D repeats it with the
    # branches switched on.
    worst = 0.0
    for i in range(4):
        im = images[i]
        with torch.inference_mode():
            out = model(torch.from_numpy(im[None]).to("cuda"))
        cls = out["x_norm_clstoken"][0].float().cpu().numpy()
        pooled = out["x_norm_patchtokens"][0].float().mean(0).cpu().numpy()
        r = responses[i]
        for name, a, b in (("cls", r.cls_feature, cls),
                           ("pooled", r.pooled_patch_feature, pooled)):
            err = float(np.abs(a - b).max())
            tol = 2.0 ** -5 * max(float(np.abs(b).max()), 1.0)
            worst = max(worst, err / tol)
            check(err <= tol, f"request {i} {name}: packed vs per-image "
                              f"{err:.3e} > {tol:.3e}")
    print(f"[C] packed vs per-image features (4 requests): worst error "
          f"{worst:.3f} of the tolerance")
    profile_pack(engine, make_mix(np.random.default_rng(3), MIXED_RAGGED,
                                  48, L.patch_size))
    return launches, packs


def profile_pack(engine, images) -> None:
    """Device time by kernel over one pack, from torch.profiler, after a
    warm-up pack and a warm-up of the tracer; only device-side events
    (kernels and copies) are summed, so nothing is counted twice. The
    wall time is that of the recorded pack, tracer included."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i, im in enumerate(images):
        engine.submit(im, request_id=20_000 + i)
    engine.flush()  # warm pack, outside the recorded one
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.ones(1, device=engine.device).sum()  # starts the tracer once
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        n_req = len(engine.flush())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    while engine.queue_len:
        engine.flush()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print("[C] profile: no device events recorded (device time not measured)")
        return
    buckets = {"K1 flash_fwd": 0.0, "K4 layernorm_fwd": 0.0, "gemm": 0.0,
               "memcpy": 0.0, "elementwise/other": 0.0}
    by_name: dict = {}
    for e in events:
        t = e.time_range.elapsed_us() / 1e3
        name = e.name
        low = name.lower()
        if "flash_fwd" in low or "flash_tile_schedule" in low:  # K1 and its schedule
            key = "K1 flash_fwd"
        elif "layernorm_fwd" in low:
            key = "K4 layernorm_fwd"
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
            key = "gemm"
        elif "memcpy" in low or "memset" in low:
            key = "memcpy"
        else:
            key = "elementwise/other"
        buckets[key] += t
        n, tt = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, tt + t)
    busy = sum(buckets.values())
    print(f"[C] profile of one pack ({n_req} requests): wall {wall_ms:.2f} ms, "
          f"device busy {busy:.2f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}; " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in buckets.items()))
    for name, (n, t) in sorted(by_name.items(), key=lambda r: -r[1][1])[:10]:
        print(f"[C]   {t:8.3f} ms  x{n:<4d} {name[:100]}")


# ---------------------------------------------------------------- phase D

def phase_d(cfg) -> None:
    """One pack through a 2-block ViT-L-width model on the card and on the
    CPU, same bf16 weights. LayerScale is set to 1 here: at the recipe's
    1e-5 the blocks' branches fall below the bf16 resolution of the
    residual stream, and the comparison would not see the kernels."""
    import torch

    from dinov3_tpu_torch.configs import apply_dot_overrides
    from dinov3_tpu_torch.models import backbone_kwargs_from_cfg, vit_large
    from dinov3_tpu_torch.serve import PackedServeEngine, serve_layout_from_cfg

    cfg = copy.deepcopy(cfg)
    apply_dot_overrides(cfg, ["student.layerscale=1.0"])
    model = vit_large(**backbone_kwargs_from_cfg(cfg), n_blocks=2)
    model.init_weights(torch.Generator().manual_seed(5))
    model = model.to(torch.bfloat16).eval()
    layout = serve_layout_from_cfg(cfg)
    rng = np.random.default_rng(2)
    images = make_mix(rng, MIXED_RAGGED, 24, layout.patch_size)
    results = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        eng = PackedServeEngine(m, layout, warn=False)
        for i, im in enumerate(images):
            eng.submit(im, request_id=i)
        t0 = time.perf_counter()
        results[dev] = {r.request_id: r for r in eng.flush()}
        print(f"[D] one pack on {dev}: {len(results[dev])} requests, "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    check(results["cuda"].keys() == results["cpu"].keys()
          and len(results["cpu"]) > 0, "card and CPU packed other requests")
    # tolerance 2^-4 of the feature magnitude: two bf16 blocks whose
    # matmuls sum in other orders on the two devices, and K1 rounds the
    # softmax probabilities to bf16 where the plain version keeps fp32
    worst = 0.0
    scale = max(float(np.abs(r.cls_feature).max())
                for r in results["cpu"].values())
    tol = 2.0 ** -4 * max(scale, 1.0)
    for i, c in results["cpu"].items():
        g = results["cuda"][i]
        for name in ("cls_feature", "pooled_patch_feature"):
            err = float(np.abs(getattr(g, name) - getattr(c, name)).max())
            worst = max(worst, err)
            check(err <= tol, f"[D] request {i} {name}: card vs CPU {err:.3e}"
                              f" > {tol:.3e}")
    print(f"[D] card vs CPU: worst feature error {worst:.3e} (tol {tol:.3e})")
    # packed vs per-image on the card with these weights, where the
    # blocks reach the features; tolerance as in phase C
    cuda_model = copy.deepcopy(model).to("cuda")
    worst = 0.0
    for i in sorted(results["cuda"])[:4]:
        with torch.inference_mode():
            out = cuda_model(torch.from_numpy(images[i][None]).to("cuda"))
        r = results["cuda"][i]
        for name, a, b in (
                ("cls", r.cls_feature,
                 out["x_norm_clstoken"][0].float().cpu().numpy()),
                ("pooled", r.pooled_patch_feature,
                 out["x_norm_patchtokens"][0].float().mean(0).cpu().numpy())):
            err = float(np.abs(a - b).max())
            ptol = 2.0 ** -5 * max(float(np.abs(b).max()), 1.0)
            worst = max(worst, err / ptol)
            check(err <= ptol, f"[D] request {i} {name}: packed vs per-image "
                               f"{err:.3e} > {ptol:.3e}")
    print(f"[D] packed vs per-image on the card (4 requests): worst error "
          f"{worst:.3f} of the tolerance")


# ---------------------------------------------------------------- phase B'

def train_attention_seg(batch_size: int = 32, rate: float = 0.3):
    """The seg plane [keep, 197] one student block's attention sees at
    ViT-L/16 with ``batch_size`` images: the packed layout's segment ids
    (2B global rows, 5 local crops of 37 tokens a packed row) gathered at
    the kept rows of a drop-path subset from the port's own plan."""
    from dinov3_tpu_torch.ops.packing import make_packed_layout, packed_segment_ids
    from dinov3_tpu_torch.rng import packed_pass_plan, step_generator

    layout = make_packed_layout(n_global_rows=2 * batch_size,
                                n_local=8 * batch_size, seq_global=197,
                                seq_local=37, n_prefix=1)
    seg = packed_segment_ids(layout)
    plan = packed_pass_plan(step_generator(0, 0), 24, layout.rows_total, rate)
    return seg[plan["drop_path"]["idx"][0, 0].numpy()]


def recipe_packed_rows() -> int:
    """The packed student pass's rows at the recipe's B=64 (2B global
    rows plus the rows of 5 local crops each)."""
    from dinov3_tpu_torch.ops.packing import make_packed_layout

    return make_packed_layout(n_global_rows=2 * RECIPE_B, n_local=8 * RECIPE_B,
                              seq_global=197, seq_local=37, n_prefix=1).rows_total


def check_flash_bwd(q, k, v, seg, label, time_it=False) -> dict:
    """K2 and K3 against ``attention_bwd_plain`` on the kernels' own O and
    LSE; each run twice, bitwise. Tolerance 2^-6 of the gradient's largest
    magnitude in bf16 (P and dS are rounded to bf16 before the second
    products, and the result is written in bf16), 1e-4 of it in fp32."""
    import torch
    import torch.nn.functional as F

    from dinov3_tpu_torch.ops.flash_attention import (
        attention_bwd_plain,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )

    g = torch.Generator().manual_seed(q.shape[1])
    do = torch.randn(q.shape, generator=g).to(q.device, q.dtype)
    out, lse, schedule = flash_fwd(q, k, v, seg)
    # K2 and K3 walk K1's schedule where they read one (bf16 with seg), as
    # in the autograd Function
    if q.dtype != torch.bfloat16:
        schedule = None
    runs = []
    for _ in range(2):
        dq, delta = flash_bwd_dq(q, k, v, out, lse, do, seg, schedule)
        dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, seg, schedule)
        runs.append((dq, dk, dv))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"K2/K3 {label}: two runs differ")
    want = attention_bwd_plain(q, k, v, out, lse, do, seg)
    row = {}
    for name, got, w in zip(("dq", "dk", "dv"), runs[0], want):
        err = (got.float() - w.float()).abs().max().item()
        mag = w.float().abs().max().item()
        tol = (2.0 ** -6 if q.dtype == torch.bfloat16 else 1e-4) * max(mag, 1e-6)
        print(f"[B'] K2/K3 {label}: max|{name} - plain| {err:.3e} (tol {tol:.3e})")
        check(np.isfinite(err) and err <= tol, f"K2/K3 {label} {name}: {err}")
        row[name] = err
    result = {"K2": {"max_abs_err": row["dq"]},
              "K3": {"max_abs_err": max(row["dk"], row["dv"])}}
    if time_it:
        B, N, H, D = q.shape
        pairs = B * N * N if seg is None else seg_pairs(seg.cpu().numpy())
        elt = B * N * H * D * q.element_size()
        rowb = B * H * N * 4
        segb = 0 if seg is None else seg.numel() * 4
        # the share of (q tile, key tile) pairs K2 walks, K1's share; K3
        # walks as many (key tile, q tile) pairs, the schedule being
        # symmetric
        walked = 1.0 if schedule is None else (
            schedule[1].sum().item() / schedule[0].numel())
        k2 = result["K2"]
        k2["walked_share"] = walked
        k2["ms"] = cuda_ms(
            lambda: flash_bwd_dq(q, k, v, out, lse, do, seg, schedule), 20)
        # K2 reads q, k, v, O, dO and LSE, writes dQ and Delta; 3 products
        k2["bound_ms"], k2["bound_by"] = bound(
            6 * elt + 2 * rowb + segb, 6 * D * H * pairs, BF16_TC_FLOP_S)
        k3 = result["K3"]
        k3["walked_share"] = walked
        k3["ms"] = cuda_ms(
            lambda: flash_bwd_dkv(q, k, v, lse, delta, do, seg, schedule), 20)
        # K3 reads q, k, v, dO, LSE and Delta, writes dK and dV; 4 products
        k3["bound_ms"], k3["bound_by"] = bound(
            6 * elt + 2 * rowb + segb, 8 * D * H * pairs, BF16_TC_FLOP_S)
        plain = cuda_ms(lambda: attention_bwd_plain(q, k, v, out, lse, do, seg), 3, 1)
        # yardstick: SDPA's backward with the boolean block mask, timed as
        # fwd + bwd minus fwd; it computes dQ, dK and dV together
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = None if seg is None else (seg[:, None, :, None] == seg[:, None, None, :])
        dot = do.transpose(1, 2)

        def fwd():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def fwd_bwd():
            torch.autograd.grad(fwd(), (qt, kt, vt), dot)

        # the median of three (fwd + bwd) - fwd pairs: one pair alone
        # varied by 2x between runs
        lib = float(np.median([cuda_ms(fwd_bwd, 20) - cuda_ms(fwd, 20)
                               for _ in range(3)]))
        for r in (k2, k3):
            r["plain_ms"], r["library_ms"] = plain, lib
        print(f"[B'] K2 {label}: kernel {k2['ms']:.4f} ms  bound {k2['bound_ms']:.4f} ms "
              f"({k2['bound_by']}), key tiles walked {k2['walked_share']:.4f};  K3: "
              f"kernel {k3['ms']:.4f} ms  bound {k3['bound_ms']:.4f} ms "
              f"({k3['bound_by']}), q tiles walked {k3['walked_share']:.4f};  K2 + K3 "
              f"{k2['ms'] + k3['ms']:.4f} ms;  plain backward {plain:.4f} ms, library "
              f"backward (dQ+dK+dV) {lib:.4f} ms")
    return result


def check_layernorm_bwd(x, s, label, time_it=False) -> dict:
    """K5 against ``layernorm_bwd_plain``, run twice, bitwise. Tolerances:
    dx one bf16 ulp plus 2^-8 of its row's largest magnitude in bf16 (both
    compute in fp32 and round once, the row sums differ in order), 1e-5 in
    fp32; dscale and dbias 1e-4 of their magnitude (fp32 sums over the
    rows in other orders)."""
    import torch
    import torch.nn.functional as F

    from dinov3_tpu_torch.ops.fused_norm import (
        layernorm_bwd,
        layernorm_bwd_plain,
        layernorm_vec_path,
    )

    g = torch.Generator().manual_seed(x.shape[0])
    dy = torch.randn(x.shape, generator=g).to(x.device, x.dtype)
    runs = [layernorm_bwd(x, s, dy) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)), f"K5 {label}: two runs differ")
    dx, ds, db = runs[0]
    wdx, wds, wdb = layernorm_bwd_plain(x, s, dy)
    err = (dx.float() - wdx.float()).abs()
    if x.dtype == torch.bfloat16:
        mag = wdx.float().abs()
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
        tol = ulp + 2.0 ** -8 * mag.amax(dim=-1, keepdim=True)
    else:
        tol = torch.full_like(err, 1e-5)
    ratio = (err / tol).max().item()
    p_err = max((ds.float() - wds.float()).abs().max().item(),
                (db.float() - wdb.float()).abs().max().item())
    p_tol = 1e-4 * max(wds.float().abs().max().item(), wdb.float().abs().max().item())
    R, D = x.shape
    vec = layernorm_vec_path(D, x.dtype, (x.data_ptr(), dy.data_ptr(), dx.data_ptr()))
    path = f"vector path, {vec} vectors a lane" if vec else "general path"
    print(f"[B'] K5 {label} ({path}): max|dx - plain| {err.max().item():.3e} "
          f"({ratio:.3f} of its tolerance), max|dscale, dbias - plain| "
          f"{p_err:.3e} (tol {p_tol:.3e})")
    check(ratio <= 1.0, f"K5 {label}: dx disagrees")
    check(p_err <= p_tol, f"K5 {label}: dscale/dbias disagree")
    row = {"max_abs_err": max(err.max().item(), p_err)}
    if time_it:
        row["ms"] = cuda_ms(lambda: layernorm_bwd(x, s, dy), 50)
        row["plain_ms"] = cuda_ms(lambda: layernorm_bwd_plain(x, s, dy), 10)
        # F.layer_norm takes scale and bias in x's dtype
        xl = x.detach().requires_grad_()
        sl = s.detach().to(x.dtype).requires_grad_()
        bl = torch.zeros_like(sl, requires_grad=True)
        y = F.layer_norm(xl, (D,), sl, bl, eps=1e-6)
        row["library_ms"] = cuda_ms(
            lambda: torch.autograd.grad(y, (xl, sl, bl), dy, retain_graph=True), 20)
        # reads x and g, writes dx (scale, dscale and dbias are [D]);
        # about 14 fp32 operations an element
        nbytes = 3 * R * D * x.element_size() + 3 * D * s.element_size()
        row["bound_ms"], row["bound_by"] = bound(nbytes, 14 * R * D, FP32_FLOP_S)
        print(f"[B'] K5 {label}: kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  library {row['library_ms']:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_b_bwd() -> dict:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    # K2/K3 at one student block's attention: [81 x 16, 197, 64] bf16, the
    # seg ids of the packed B=32 layout after a drop-path subset, q, k, v
    # as the qkv projection lays them out (v a strided view)
    seg = torch.from_numpy(train_attention_seg()).to(dev)
    R, N = seg.shape
    H, D = 16, 64
    qkv = randn(R, N, 3 * H * D)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(R, N, H, D)
               for i in range(3))
    rows = check_flash_bwd(q.contiguous(), k.contiguous(), v, seg,
                           f"train block [{R}x{H}, {N}, {D}] bf16 seg",
                           time_it=True)
    check_flash_bwd(randn(4, 201, 6, 64), randn(4, 201, 6, 64),
                    randn(4, 201, 6, 64), None, "ragged N=201 [4x6, 201, 64] bf16")
    s128 = torch.zeros(2, 333, dtype=torch.int32, device=dev)
    s128[:, 150:] = 1
    s128[:, 320:] = -1
    check_flash_bwd(randn(2, 333, 8, 128), randn(2, 333, 8, 128),
                    randn(2, 333, 8, 128), s128, "head_dim 128 [2x8, 333, 128] bf16 seg")
    f32 = torch.float32
    check_flash_bwd(randn(2, 150, 4, 64, dtype=f32), randn(2, 150, 4, 64, dtype=f32),
                    randn(2, 150, 4, 64, dtype=f32), seg[-2:, :150].contiguous(),
                    "[2x4, 150, 64] fp32 seg")
    rng = np.random.default_rng(5)
    shuffled = torch.from_numpy(rng.integers(-3, 6, (4, 201)).astype(np.int32)).to(dev)
    check_flash_bwd(randn(4, 201, 4, 64), randn(4, 201, 4, 64), randn(4, 201, 4, 64),
                    shuffled, "shuffled ids with negatives [4x4, 201, 64] bf16")
    pad = seg[-3:].clone()
    pad[0] = -1  # one row of nothing but pad tokens
    check_flash_bwd(randn(3, N, 4, 64), randn(3, N, 4, 64), randn(3, N, 4, 64),
                    pad, f"all-pad row [3x4, {N}, 64] bf16")
    # K2/K3 at one student block of the recipe's B=64 step
    rseg = torch.from_numpy(train_attention_seg(RECIPE_B)).to(dev)
    rqkv = randn(rseg.shape[0], N, 3 * H * D)
    rq, rk, rv = (rqkv[..., i * H * D:(i + 1) * H * D].reshape(rseg.shape[0], N, H, D)
                  for i in range(3))
    recipe = check_flash_bwd(rq.contiguous(), rk.contiguous(), rv, rseg,
                             f"recipe block [{rseg.shape[0]}x{H}, {N}, {D}] bf16 seg",
                             time_it=True)
    for key in ("K2", "K3"):
        rows[key]["train_shapes"] = {"recipe student": recipe[key]}
    del rqkv, rq, rk, rv
    # K5 at a student block's norms ([81 x 197, 1024] bf16 with the fp32
    # master scale: 48 of a step's 50 launches, phase E) and at all the
    # packed student rows ([116 x 197, 1024])
    s = (torch.randn(1024, generator=g) * 0.5 + 1).to(dev)
    rows["K5"] = check_layernorm_bwd(
        randn(81 * 197, 1024) * 3 + 1, s,
        "train student block [15957, 1024] bf16, fp32 scale", time_it=True)
    rows["K5"]["train_shapes"] = {"packed rows": check_layernorm_bwd(
        randn(116 * 197, 1024) * 3 + 1, s, "packed rows [22852, 1024] bf16, fp32 scale",
        time_it=True)}
    # and at the recipe's B=64: a student block's norms and all its
    # packed student rows
    r_rows = train_attention_seg(RECIPE_B).shape[0] * 197
    rows["K5"]["train_shapes"]["recipe student block"] = check_layernorm_bwd(
        randn(r_rows, 1024) * 3 + 1, s,
        f"recipe student block [{r_rows}, 1024] bf16, fp32 scale", time_it=True)
    p_rows = recipe_packed_rows() * 197
    rows["K5"]["train_shapes"]["recipe packed rows"] = check_layernorm_bwd(
        randn(p_rows, 1024) * 3 + 1, s,
        f"recipe packed rows [{p_rows}, 1024] bf16, fp32 scale", time_it=True)
    check_layernorm_bwd(randn(1003, 1024), s, "ragged rows [1003, 1024] bf16")
    check_layernorm_bwd(randn(100, 1024), s, "fewer rows than CTAs [100, 1024] bf16")
    check_layernorm_bwd(randn(77, 96, dtype=f32), s[:96].contiguous(),
                        "[77, 96] fp32")
    check_layernorm_bwd(randn(50, 2048), s.repeat(2), "[50, 2048] bf16")
    check_layernorm_bwd(randn(9, 1000), s[:1000].contiguous(), "[9, 1000] bf16")
    check_layernorm_bwd(randn(9, 4096), s.repeat(4), "[9, 4096] bf16 (general path)")
    return rows


# ---------------------------------------------------------------- phase E

TRAIN_B = 32
TRAIN_OVERRIDES = [f"train.batch_size_per_device={TRAIN_B}",
                   "loss.streaming_targets=false", "data.backend=synthetic"]
# launches of each kernel in one step of the ViT-L/16 slice: K1 24 teacher
# + 24 student blocks; K4 two per block in each backbone plus the final
# norm (teacher 49) and the final and local-CLS norms (student 50); the
# backward kernels once per student launch of their forward
STEP_LAUNCHES = {"K1": 48, "K2": 24, "K3": 24, "K4": 99, "K5": 50}
LOSS_KEYS = ("dino_local_crops_loss", "dino_global_crops_loss", "koleo_loss",
             "ibot_loss", "total_loss")


def phase_e() -> tuple[dict, dict]:
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup, put_batch

    cfg = load_config(os.path.join(REPO, "configs", "train", "vitl16_im1k.yaml"),
                      TRAIN_OVERRIDES, n_devices=1)
    batch = make_synthetic_batch(cfg, TRAIN_B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = build_train_setup(cfg, batch, device="cuda", seed=0)
    meta = setup.meta
    bb = meta.student["backbone"]
    n_params = sum(p.numel() for p in meta.student.parameters())
    print(f"[E] ViT-L/16 SSL step: {bb.n_blocks} blocks, width {bb.embed_dim}, "
          f"{bb.num_heads} heads, {n_params} student parameters (fp32 masters), "
          f"{cfg.dino.head_n_prototypes} prototypes, B={TRAIN_B}, lr "
          f"{cfg.optim.lr:.3e}; built in {time.perf_counter() - t0:.1f} s")
    check(bb.n_blocks == 24 and bb.embed_dim == 1024 and bb.num_heads == 16
          and cfg.crops.local_crops_number == 8, "not the ViT-L/16 slice")
    dbatch = put_batch(batch, "cuda")  # data loading is set-up
    state = setup.state
    state, m = setup.step_fn(state, dbatch, setup.scalars(state.step))  # warm-up
    torch.cuda.synchronize()
    print(f"[E] warm-up step: " + ", ".join(f"{k} {m[k]:.4f}" for k in LOSS_KEYS))
    reset_counts()
    times = []
    gc_ms = []  # Python garbage collections during the timed steps, by clock
    gc_start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_ms.append((info["generation"], (time.perf_counter() - gc_start[0]) * 1e3))

    gc.callbacks.append(on_gc)
    for _ in range(5):
        gc_ms.clear()
        alloc0 = torch.cuda.memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, dbatch, setup.scalars(state.step))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        alloc = torch.cuda.memory_stats()
        check(all(np.isfinite(m[k]) for k in LOSS_KEYS), f"non-finite loss {m}")
        print(f"[E] step {state.step - 1}: {times[-1]:.1f} ms, "
              f"{TRAIN_B / times[-1] * 1e3:.2f} img/s; " + ", ".join(
                  f"{k} {m[k]:.4f}" for k in LOSS_KEYS) + "; grad norms " +
              ", ".join(f"{k[10:]} {v:.3e}" for k, v in m.items()
                        if k.startswith("grad_norm/")) +
              "; allocator " + ", ".join(
                  f"{k} {alloc.get(k, 0) - alloc0.get(k, 0)}" for k in
                  ("num_device_alloc", "num_device_free", "num_alloc_retries")) +
              "; Python gc " + ", ".join(f"gen{g} {ms:.1f} ms" for g, ms in gc_ms))
    gc.callbacks.remove(on_gc)
    launches = read_counts()
    per_step = {k: v / 5 for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[E] 5 steps: median {np.median(times):.1f} ms, mean {np.mean(times):.1f} ms (min {min(times):.1f}, max "
          f"{max(times):.1f}), {TRAIN_B / np.mean(times) * 1e3:.2f} img/s, peak "
          f"memory {peak:.2f} GiB; launches per step {per_step}")
    check(per_step == STEP_LAUNCHES, f"launches per step {per_step} != {STEP_LAUNCHES}")
    norm_bwd_shapes(setup, state, dbatch)
    sync_points(setup, state, dbatch)
    batch_copy_times(cfg, batch)
    profile_step(setup, state, batch)
    return launches, {"ms": float(np.mean(times)), "median_ms": float(np.median(times)),
                      "peak_gib": peak}


def sync_sites(fn):
    """The calls in fn() that make the host wait for the card, from
    ``torch.cuda.set_sync_debug_mode``'s warnings, by file and line of the
    port's innermost frame (a Counter); fn's result."""
    import threading
    import traceback
    import warnings
    from collections import Counter

    import torch

    sites = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            # the innermost frame of the port: the call that synchronized
            frames = [f for f in traceback.extract_stack()[:-1]
                      if f.filename.startswith(os.path.join(REPO, "dinov3_tpu_torch"))]
            if frames:
                site = f"{os.path.relpath(frames[-1].filename, REPO)}:{frames[-1].lineno}"
            else:  # no frame of the port: name the thread and the frames there are
                site = f"{threading.current_thread().name}: " + " <- ".join(
                    f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                    for f in reversed(traceback.extract_stack()[-5:-1]))
            sites[site] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # switched on before the recorder: the switch warns of itself
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = record
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites, out


def sync_points(setup, state, dbatch, label: str = "E") -> None:
    """The synchronizing calls in one step's launch (``launch_fn``, before
    its metrics are read), by file and line."""
    sites, (_, pending) = sync_sites(
        lambda: setup.launch_fn(state, dbatch, setup.scalars(state.step)))
    pending.read()
    print(f"[{label}] synchronizing calls in one step launch: {sum(sites.values())}"
          + "".join(f"; {n} x {site}" for site, n in sites.most_common(12)))


def norm_bwd_shapes(setup, state, dbatch) -> None:
    """The [rows, D] shapes K5 runs at in one training step (after the
    counted steps): the autograd Function's call of ``layernorm_bwd`` is
    wrapped for that one step to record its input shapes."""
    from collections import Counter

    import dinov3_tpu_torch.ops.fused_norm as fused_norm

    seen = Counter()
    inner = fused_norm.layernorm_bwd

    def recording(x, *args, **kwargs):
        seen[(x.numel() // x.shape[-1], x.shape[-1])] += 1
        return inner(x, *args, **kwargs)

    fused_norm.layernorm_bwd = recording
    try:
        setup.step_fn(state, dbatch, setup.scalars(state.step))
    finally:
        fused_norm.layernorm_bwd = inner
    print("[E] K5 shapes in one step: " + ", ".join(
        f"{n} x [{r}, {d}]" for (r, d), n in sorted(seen.items(), key=lambda kv: -kv[1])))


def put_pageable(batch: dict) -> dict:
    """The host batch copied to the card from pageable memory, without
    the pinning ``put_batch`` does first."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda", non_blocking=True)
            for k, v in batch.items()}


def batch_copy_times(cfg, host_batch) -> None:
    """The host time to make one synthetic batch, and the training batch's
    host-to-device copy from pageable memory (the put call waits for it) and through ``put_batch`` from pinned memory
    (the trainer pins on its data thread, ``pin_batch``): the host time of
    the pin and of the put call, and the copy's time on the card's clock
    from CUDA events around the put (median of 5 after a warm-up, the card
    idle before each)."""
    import torch

    from dinov3_tpu_torch.train import put_batch
    from dinov3_tpu_torch.train.train import pin_batch

    from dinov3_tpu_torch.data import make_synthetic_batch

    made = []
    for i in range(3):  # the host work the trainer's data thread does a step
        t0 = time.perf_counter()
        make_synthetic_batch(cfg, TRAIN_B, seed=(0, 0, i))
        made.append((time.perf_counter() - t0) * 1e3)
    print(f"[E] one synthetic batch of {TRAIN_B} images made on the host in "
          f"{np.median(made):.1f} ms (median of 3)")
    nbytes = sum(v.nbytes for v in host_batch.values())
    for label in ("pageable", "pinned"):
        pin, host, dev = [], [], []
        for _ in range(6):
            src = host_batch
            if label == "pinned":
                t0 = time.perf_counter()
                src = pin_batch(host_batch)
                pin.append((time.perf_counter() - t0) * 1e3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            if label == "pinned":
                put_batch(src, "cuda")
            else:
                put_pageable(src)
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            dev.append(start.elapsed_time(end))
        copy_ms = float(np.median(dev[1:]))
        print(f"[E] batch copy ({nbytes} bytes) from {label} memory: the put call "
              f"holds the host {np.median(host[1:]):.2f} ms"
              + (f" (pinning first: {np.median(pin[1:]):.2f} ms)" if pin else "")
              + f"; the copy takes {copy_ms:.2f} ms on the card's clock "
              f"({nbytes / copy_ms / 1e6:.1f} GB/s)")


def profile_step(setup, state, host_batch, label: str = "E", extra_classes=()) -> dict:
    """Device time by kernel class over one training step whose batch is
    put on the card (``put_batch``, pinned) inside the recorded window,
    from torch.profiler device events (the tracer warmed up first); the
    wall time is that of the recorded step, tracer included. Returns the
    wall and busy ms and the ms by class ({} without device events).
    ``extra_classes``: (name, name fragments) classes taken after K1-K5
    and before the GEMMs (the convolutions of a ConvNeXt step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dinov3_tpu_torch.train import put_batch

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.ones(1, device="cuda").sum()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        dbatch = put_batch(host_batch, "cuda")
        setup.step_fn(state, dbatch, setup.scalars(state.step))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"[{label}] profile: no device events recorded (device time not measured)")
        return {}
    h2d = [e.time_range.elapsed_us() / 1e3 for e in events if "htod" in e.name.lower()]
    print(f"[{label}] profiled step: host-to-device memcpy {sum(h2d):.3f} ms in {len(h2d)} "
          f"copies ({sorted({e.name for e in events if 'htod' in e.name.lower()})})")
    classes = (("K1 flash_fwd", ("flash_fwd", "flash_tile_schedule")),
               ("K2 flash_bwd_dq", ("flash_bwd_dq",)),
               ("K3 flash_bwd_dkv", ("flash_bwd_dkv",)),
               ("K4 layernorm_fwd", ("layernorm_fwd",)),
               ("K5 layernorm_bwd", ("layernorm_bwd",))) + tuple(extra_classes)
    buckets = {name: 0.0 for name, _ in classes}
    buckets.update({"gemm": 0.0, "memcpy": 0.0, "elementwise/other": 0.0})
    by_name: dict = {}
    for e in events:
        t = e.time_range.elapsed_us() / 1e3
        low = e.name.lower()
        key = next((name for name, tags in classes if any(tag in low for tag in tags)), None)
        if key is None:
            if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
                key = "gemm"
            elif "memcpy" in low or "memset" in low:
                key = "memcpy"
            else:
                key = "elementwise/other"
        buckets[key] += t
        n, tt = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tt + t)
    busy = sum(buckets.values())
    print(f"[{label}] profile of one step (batch put inside it): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}; " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in buckets.items()))
    for name, (n, t) in sorted(by_name.items(), key=lambda r: -r[1][1])[:12]:
        print(f"[{label}]   {t:8.3f} ms  x{n:<4d} {name[:100]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, **buckets}


# ---------------------------------------------------------------- phase F

def phase_f() -> None:
    """One step of a 2-block ViT-L-width model on the card and on the CPU,
    same weights (drawn on the CPU from one seed), batch and drop-path
    plan, at a mid-schedule iteration where lr is at its peak. LayerScale
    is 1 so the blocks reach the losses."""
    card_vs_cpu_step("F", ["loss.streaming_targets=false"])


def card_vs_cpu_step(label: str, overrides: list, config: str | None = None,
                     batch: dict | None = None, moved_close: float = 0.9,
                     planted: str | None = None, n_blocks: int | None = 2):
    """The phase-F pattern under ``config`` (the ViT-L/16 recipe when None)
    and ``overrides``: an ``n_blocks``-block model at the config's width (4096 prototypes, B=4, LayerScale 1) takes
    one step on the card and one on the CPU from the same weights, batch
    (``batch``, else a synthetic one) and plans (drawn on the host by the
    meta-arch, one a microbatch under ``optim.accum_steps``); loss terms,
    gradient norms and the updated student compared (``moved_close``: the
    share of moved entries within a tenth of their step). ``planted``
    (``planted_backward``) runs the card's step once more under that
    wrong backward and prints its share, which is not held. A distillation
    teacher is drawn on each run's device: the card's is copied into the
    CPU's. Returns the card's set-up after its step."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup
    from dinov3_tpu_torch.train.train_step import split_microbatches

    B = 4
    cfg = load_config(
        os.path.join(REPO, config or CLI_CONFIG),
        [f"train.batch_size_per_device={B}", "student.layerscale=1.0",
         "dino.head_n_prototypes=4096", "ibot.head_n_prototypes=4096", *overrides],
        n_devices=1)
    if batch is None:
        batch = make_synthetic_batch(cfg, cfg.train.batch_size_per_device, seed=1)
    it = cfg.optim.warmup_epochs * cfg.train.OFFICIAL_EPOCH_LENGTH
    accum = int(cfg.optim.accum_steps)
    plans = teacher = None
    results = {}
    for dev in ("cuda", "cpu") + (("planted",) if planted else ()):
        setup = build_train_setup(cfg, batch, device="cuda" if dev == "planted" else dev,
                                  seed=2, n_blocks=n_blocks)
        if setup.meta.distillation:
            if teacher is None:
                teacher = {k: v.cpu() for k, v in setup.meta.teacher.state_dict().items()}
            setup.meta.teacher.load_state_dict(teacher)
        if plans is None:  # drawn once on the host: both devices take these
            plans = [setup.meta.draw_plan(0, it, mb, None if accum == 1 else j)
                     for j, mb in enumerate(split_microbatches(batch, accum))]
            # a recipe without drop path (the distilled one) draws no plan
            check(all(plans) or not cfg.student.drop_path_rate,
                  f"[{label}] no drop-path plan")
        state = setup.state
        state.step = state.opt_state.count = it
        before = {n: p.detach().cpu().clone()
                  for n, p in setup.meta.student.named_parameters()}
        t0 = time.perf_counter()
        with planted_backward(planted) if dev == "planted" else contextlib.nullcontext():
            state, m = setup.step_fn(state, batch, setup.scalars(it),
                                     plan=plans if accum > 1 else plans[0])
        print(f"[{label}] one step on {dev}: {(time.perf_counter() - t0) * 1e3:.1f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in m.items() if not k.startswith("grad")))
        after = {n: p.detach().cpu() for n, p in setup.meta.student.named_parameters()}
        results[dev] = (m, before, after)
        if dev == "cuda":
            card = setup
    (mc, before, after_c), (mp, before_p, after_p) = results["cuda"], results["cpu"]
    check(all(torch.equal(before[n], before_p[n]) for n in before),
          "card and CPU started from other weights")
    # losses and gradient norms: 2^-5 relative. Both sides compute in bf16,
    # with matmul sums in other orders, and K1-K3 round the attention
    # probabilities and dS to bf16 where the plain versions keep fp32
    worst = 0.0
    check(mc.keys() == mp.keys(), f"[{label}] card metrics {sorted(mc)} != CPU's {sorted(mp)}")
    for k in mc:  # the loss terms (the Gram terms under gram.use_loss), the norms
        rel = abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-6)
        worst = max(worst, rel)
        check(rel <= 2.0 ** -5, f"[{label}] {k}: card {mc[k]:.6g} vs CPU {mp[k]:.6g}")
    print(f"[{label}] card vs CPU: loss terms and gradient norms within {worst:.3e} "
          f"relative (tol {2.0 ** -5:.3e})")
    # updated student: from fresh moments Adam moves each entry by
    # lr * lr_mult * (1 - b1) / sqrt(1 - b2) * sign(g), plus weight decay;
    # an entry whose gradient is near bf16 noise can move either way, so
    # every entry lies within twice its leaf's largest CPU step of the
    # CPU's, and 90 % of the moved entries within a tenth of their step
    lr = float(setup.schedules.lr[it])

    def moved_share(after_c: dict, hold: bool) -> float:
        close = total = 0
        for n in before:
            d_c, d_p = after_c[n] - before[n], after_p[n] - before[n]
            err = (d_c - d_p).abs()
            step = d_p.abs().max().item()
            if hold:
                check(err.max().item() <= 2 * step + 1e-6,
                      f"[{label}] {n}: update differs by {err.max().item():.3e} > 2 x {step:.3e}")
            moved = d_p.abs() > 0.1 * step
            close += int((err[moved] <= 0.1 * d_p.abs()[moved]).sum())
            total += int(moved.sum())
        return close / total

    share = moved_share(after_c, True)
    print(f"[{label}] updated student: {share:.4f} of the moved entries within "
          f"a tenth of their step (lr {lr:.3e}; tol {moved_close})")
    check(share >= moved_close, f"[{label}] updated students disagree")
    if planted:
        print(f"[{label}] the card's step under the planted {planted} backward: "
              f"{moved_share(results['planted'][2], False):.4f} of the moved entries "
              f"within a tenth of their step (not held)")
    return card


# ---------------------------------------------------------------- phase G

G_DIR = os.path.join(REPO, "build", "phase_g")
CLI_CONFIG = os.path.join("configs", "train", "vitl16_im1k.yaml")
# the trainer's command of the ViT-L/16 slice: B=32, materialized targets,
# synthetic data, a save every 2 iterations, at ViT-L width cut to
# CLI_DEPTH blocks: what phases G, I4, I5 and J4 check of these runs
# (resume, torn saves, the self-check, the folder pipeline, the eval CLI
# and evals in a run, serving from a checkpoint) does not depend on the
# depth, and phases H7 and K1 run the CLI at full depth
CLI_DEPTH = 4
CLI_OVERRIDES = TRAIN_OVERRIDES + ["checkpointing.period=2",
                                   f"+student.n_blocks={CLI_DEPTH}"]


def step_launches(depth: int) -> dict:
    """K1-K5 launches of one step of a ``depth``-block ViT: K1 once a
    teacher and a student block; K4 twice a block in each backbone, plus
    the teacher's final norm and the student's final and local-CLS norms;
    K2, K3 and K5 once a student K1 or K4 launch."""
    return {"K1": 2 * depth, "K2": depth, "K3": depth, "K4": 4 * depth + 3,
            "K5": 2 * depth + 2}


CLI_STEP_LAUNCHES = step_launches(CLI_DEPTH)


def ckpt_cfg(cfg):
    """``cfg`` at the depth of phase G's checkpoints."""
    from dinov3_tpu_torch.configs import apply_dot_overrides

    out = copy.deepcopy(cfg)
    apply_dot_overrides(out, [f"+student.n_blocks={CLI_DEPTH}"])
    return out


def run_cli(name: str, args: list, overrides=(), timeout: int = 420,
            base=CLI_OVERRIDES, label: str = "G", log_dir: str = G_DIR,
            config: str = CLI_CONFIG) -> dict:
    """One run of ``python -m dinov3_tpu_torch.train.train`` as a child
    process with a time limit (``config``, the ``base`` overrides, then
    ``overrides``); its output goes to ``<log_dir>/<name>.log`` and its
    last line is its result. Raises on a non-zero exit."""
    cmd = [sys.executable, "-m", "dinov3_tpu_torch.train.train",
           "--config-file", config, *args, *base, *overrides]
    spawned = time.time()  # the start-up split's origin (``startup_split``)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(log_dir, f"{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tail = (proc.stdout + proc.stderr).splitlines()[-40:]
        raise SmokeFailure(f"[{label}] {name}: exit {proc.returncode}\n" + "\n".join(tail))
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    result["wall_s"], result["spawned"] = wall, spawned
    print(f"[{label}] {name}: {wall:.1f} s wall; start {result.get('start_iteration')}, "
          f"iterations {result.get('iterations')}, launches {result['launches']}"
          + (f"; --benchmark {result['ms_per_step']:.2f} ms a step, "
             f"{result['img_per_sec']:.2f} img/s (steps "
             + ", ".join(f"{t:.1f}" for t in result["step_ms"]) + " ms)"
             if "ms_per_step" in result else "")
          + "".join(f"; save step {v['step']}: {v['bytes']} bytes in {v['seconds']:.2f} s"
                    for v in result.get("saves", []))
          + (f"; restore {result['restore_s']:.2f} s" if "restore_s" in result else "")
          + (f"; peak {result['peak_memory_gib']:.2f} GiB" if "peak_memory_gib" in result else "")
          + (f"; gc {result['gc']}" if "gc" in result else ""))
    return result


def check_launches(name: str, result: dict, steps: int) -> None:
    want = {k: v * steps for k, v in CLI_STEP_LAUNCHES.items()}
    check(result["launches"] == want,
          f"[G] {name}: launches {result['launches']} != {want} ({steps} steps)")


def read_losses(path: str) -> dict:
    with open(path) as f:
        return {r["iteration"]: r for r in map(json.loads, f)}


def teacher_of(run_dir: str, step: int) -> dict:
    import torch

    payload = torch.load(os.path.join(run_dir, "ckpt", str(step), "state.pt"),
                         map_location="cpu", weights_only=True, mmap=True)
    return payload["teacher"]


def check_dump(label: str, path: str, result: dict, ckpt: str) -> None:
    """``--dump-weights``: the flat ``.npz`` of the final student and
    teacher equals the run's own last checkpoint, bit for bit."""
    import torch

    dumped = np.load(path)
    saved = torch.load(ckpt, map_location="cpu", weights_only=True, mmap=True)
    want = {f"{role}/{n}".replace(".", "/"): t for role in ("student", "teacher")
            for n, t in saved[role].items()}
    check(set(dumped.files) == set(want) and result["dump_weights"]["arrays"] == len(want),
          f"[{label}] dumped names")
    check(all(np.array_equal(dumped[k], want[k].float().numpy()) for k in want),
          f"[{label}] the dump differs from the run's checkpoint")
    print(f"[{label}] --dump-weights: {len(want)} arrays, {result['dump_weights']['bytes']} "
          f"bytes, equal to the run's last checkpoint bit for bit")


def plant_torn_saves(ckpt_dir: str, step: int = 3) -> None:
    """A save cut before its rename (``tmp.<step>/`` holding a partial
    payload) and one cut before its marker (``<step>/`` with a payload, no
    FINALIZED)."""
    for d in (f"tmp.{step}", str(step)):
        os.makedirs(os.path.join(ckpt_dir, d))
        with open(os.path.join(ckpt_dir, d, "state.pt"), "wb") as f:
            f.write(b"PK\x03\x04 torn payload")


def phase_g(step: dict) -> dict:
    """The trainer CLI at ViT-L/16, B=32 on the card (module docstring)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()  # the children need the card's memory
    shutil.rmtree(G_DIR, ignore_errors=True)
    os.makedirs(G_DIR)
    from dinov3_tpu_torch.configs import load_config

    try:
        return _phase_g(load_config(os.path.join(REPO, CLI_CONFIG), TRAIN_OVERRIDES,
                                    n_devices=1))
    finally:
        shutil.rmtree(G_DIR, ignore_errors=True)


def _phase_g(cfg) -> dict:
    from dinov3_tpu_torch.train.schedules import build_schedules

    # 12 iterations, the last 8 timed, a save every 4 (each save's seconds
    # are kept out of the timed steps); its step-4 checkpoint is phase I's
    # and the resume's below
    a_dir, r_dir = os.path.join(G_DIR, "a"), os.path.join(G_DIR, "r")
    a_losses = os.path.join(G_DIR, "a.jsonl")
    a = run_cli("uninterrupted", ["--output-dir", a_dir, "--max-iterations", "12",
                                  "--benchmark", "8", "--record-losses", a_losses],
                ["checkpointing.period=4"])
    check_launches("uninterrupted", a, 12)
    check([s["step"] for s in a["saves"]] == [4, 8, 12], f"[G] saves {a['saves']}")
    losses = read_losses(a_losses)
    check(sorted(losses) == list(range(12)) and all(
        np.isfinite(v) for r in losses.values() for k, v in r.items() if k != "iteration"),
        f"[G] uninterrupted losses {losses}")
    # a new process resumes from the step-4 save (linked into its own
    # directory, beside a torn tmp.5/ and an unfinalized 5/) to 8, and dumps
    # its final weights (--dump-weights)
    os.makedirs(os.path.join(r_dir, "ckpt", "4"))
    for f in os.listdir(os.path.join(a_dir, "ckpt", "4")):
        os.link(os.path.join(a_dir, "ckpt", "4", f), os.path.join(r_dir, "ckpt", "4", f))
    plant_torn_saves(os.path.join(r_dir, "ckpt"), 5)
    # the self-check and the image-folder pipeline (2 steps on texture
    # images, PIL on the host) run beside the resume: none of the three is
    # timed, and each holds ~12 GiB of the card
    from concurrent.futures import ThreadPoolExecutor

    from dinov3_tpu_torch.data.textures import materialize_textures

    t0 = time.perf_counter()
    train_dir, _ = materialize_textures(os.path.join(G_DIR, "textures"),
                                        n_train_per_class=8, n_val_per_class=0,
                                        px=256, seed=0)
    print(f"[G] 96 texture images of 256 px written in {time.perf_counter() - t0:.1f} s")
    beside = ThreadPoolExecutor(max_workers=2)
    sc_run = beside.submit(run_cli, "self-check",
                           ["--output-dir", os.path.join(G_DIR, "s"), "--self-check"])
    folder_run = beside.submit(
        run_cli, "folder", ["--output-dir", os.path.join(G_DIR, "f"), "--max-iterations", "2"],
        ["data.backend=folder", f"train.dataset_path=Folder:root={train_dir}",
         "train.num_workers=8"])
    beside.shutdown(wait=False)
    r_losses, dump = os.path.join(G_DIR, "r.jsonl"), os.path.join(G_DIR, "w.npz")
    r = run_cli("resumed to 8", ["--output-dir", r_dir, "--max-iterations", "8",
                                 "--record-losses", r_losses, "--ref-losses", a_losses,
                                 "--dump-weights", dump], ["checkpointing.period=4"])
    check(r["start_iteration"] == 4 and r["iterations"] == 8,
          f"[G] resumed at {r['start_iteration']}, not at 4 past the torn saves")
    check_launches("resumed to 8", r, 4)
    # resumed losses against the uninterrupted run's: the CLI's own
    # comparator, |err| <= 1e-4 + 1e-3 |recorded| (index_add on the card
    # sums with atomics, so the runs need not be bitwise equal)
    resumed = read_losses(r_losses)
    diffs = [abs(resumed[i][k] - losses[i][k]) for i in range(4, 8) for k in resumed[i]
             if k != "iteration"]
    print(f"[G] resumed vs uninterrupted losses at iterations 4-7: largest "
          f"|difference| {max(diffs):.3e}, bitwise {max(diffs) == 0.0}; "
          f"{r['loss_comparison']}")
    check(sorted(resumed) == [4, 5, 6, 7] and r["loss_divergences"] == 0,
          f"[G] resumed losses diverge: {r['loss_comparison']}")
    # the final teacher: from the same start each resumed step's AdamW
    # update of an entry may differ by 4 lr (an update whose gradient is at
    # noise level can go either way, |update| <= 2 lr in these first
    # steps), so the students by the sum of those up to a step, and the EMA
    # takes (1 - m) of that difference each step; plus 1e-5 of each
    # tensor's largest magnitude
    sched = build_schedules(cfg)
    lr = [float(sched.lr[i]) for i in range(4, 8)]
    mom = [1 - float(sched.momentum[i]) for i in range(4, 8)]
    drift = sum(m * 4 * sum(lr[:j + 1]) for j, m in enumerate(mom))
    ta, tr = teacher_of(a_dir, 8), teacher_of(r_dir, 8)
    worst, worst_ratio, same = 0.0, 0.0, True
    for n, w in ta.items():
        err = (tr[n] - w).abs().max().item()
        tol = drift + 1e-5 * max(w.abs().max().item(), 1e-3)
        same = same and err == 0.0
        worst, worst_ratio = max(worst, err), max(worst_ratio, err / tol)
        check(err <= tol, f"[G] teacher {n}: resumed vs uninterrupted {err:.3e} > {tol:.3e}")
    print(f"[G] final teacher, resumed vs uninterrupted: largest |difference| "
          f"{worst:.3e} ({worst_ratio:.3f} of its tolerance), bitwise {same}")
    del ta, tr
    check_dump("G", dump, r, os.path.join(r_dir, "ckpt", "8", "state.pt"))
    shutil.rmtree(I_DIR, ignore_errors=True)
    os.makedirs(I_CKPT)
    os.rename(os.path.join(a_dir, "ckpt", "4"), os.path.join(I_CKPT, "4"))
    shutil.rmtree(a_dir)
    shutil.rmtree(r_dir)
    os.remove(dump)

    sc = sc_run.result()
    failed = [k for k, v in sc.items() if k.startswith("check/") and not v]
    print(f"[G] self-check at full width, {CLI_DEPTH} blocks: "
          f"{sum(k.startswith('check/') for k in sc)} "
          f"checks, failures {failed}")
    check(sc["self_check_failures"] == 0 and not failed, f"[G] self-check failed: {failed}")
    check_launches("self-check", sc, 2)
    folder = folder_run.result()
    check_launches("folder", folder, 2)
    check(np.isfinite(folder["final_loss"]), f"[G] folder run loss {folder['final_loss']}")

    print(f"[G] CLI --benchmark at {CLI_DEPTH} blocks: {a['img_per_sec']:.2f} img/s "
          f"({a['ms_per_step']:.1f} ms a step over 8 steps)")
    return {"uninterrupted": a, "benchmark": a, "resumed": r}


# ---------------------------------------------------------------- phase H

H_DIR = os.path.join(REPO, "build", "phase_h")
# the recipe as written: only the data backend changes (the recipe's
# imagenet backend needs a dataset no run here can download)
RECIPE_OVERRIDES = ["data.backend=synthetic"]
# the remat arms recompute each student block's forward in the backward:
# K1 once more and K4 twice more a block
REMAT_LAUNCHES = {"K1": 72, "K2": 24, "K3": 24, "K4": 147, "K5": 50}
# step-0 loss terms of two arms that differ only in how the targets are
# summed (streaming vs materialized) or in what the backward recomputes:
# fp32 sums of 65,536 terms in other orders, 1e-4 relative
H_LOSS_RTOL = 1e-4


def recipe_arm(label: str, extra: list, steps: int, launches: dict | None,
               profile: bool = False, window: bool = False) -> dict:
    """The recipe at full width and depth under ``extra``, through
    ``build_train_setup`` + ``step_fn``: step 0 as the warm-up (its loss
    terms kept for the comparisons), then ``steps`` timed steps with every
    loss finite and, where ``launches`` is given, K1-K5 launches pinned
    per step. Returns the step-0 losses, the times, the peak memory and
    the launches; optionally one profiled step and the step's host waits,
    or (``window``) a 2-step profiled window read by the step anatomy."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup, put_batch
    from dinov3_tpu_torch.train.train import resolved_engine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = load_config(os.path.join(REPO, CLI_CONFIG), RECIPE_OVERRIDES + extra, n_devices=1)
    B = cfg.train.batch_size_per_device
    batch = make_synthetic_batch(cfg, B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = build_train_setup(cfg, batch, device="cuda", seed=0)
    engine = resolved_engine(setup)
    print(f"[{label}] {' '.join(extra) or 'the recipe as written'}: B={B}, {engine}; "
          f"built in {time.perf_counter() - t0:.1f} s")
    dbatch = put_batch(batch, "cuda")
    state, m0 = setup.step_fn(setup.state, dbatch, setup.scalars(0))
    torch.cuda.synchronize()
    check(all(np.isfinite(m0[k]) for k in LOSS_KEYS), f"[{label}] non-finite step 0 {m0}")
    print(f"[{label}] step 0 (warm-up): " + ", ".join(f"{k} {m0[k]:.6f}" for k in LOSS_KEYS))
    reset_counts()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, dbatch, setup.scalars(state.step))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(m[k]) for k in LOSS_KEYS), f"[{label}] non-finite loss {m}")
    counts = read_counts()
    per_step = {k: v / steps for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {"m0": m0, "last": m, "median_ms": float(np.median(times)),
           "mean_ms": float(np.mean(times)), "peak_gib": peak, "launches": counts,
           "per_step": per_step, "B": B, "state": state, "drift": setup.lowp_drift,
           "divergence_tol": setup.lowp["divergence_tol"]}
    print(f"[{label}] {steps} steps: median {out['median_ms']:.1f} ms, mean "
          f"{out['mean_ms']:.1f} ms ({', '.join(f'{t:.1f}' for t in times)}), "
          f"{B / out['median_ms'] * 1e3:.2f} img/s at the median, peak {peak:.2f} GiB; "
          f"launches per step {per_step}; last " +
          ", ".join(f"{k} {m[k]:.4f}" for k in LOSS_KEYS))
    if launches is not None:
        check(per_step == launches, f"[{label}] launches per step {per_step} != {launches}")
    if profile:
        sync_points(setup, state, dbatch, label)
        out["profile"] = profile_step(setup, state, batch, label)
    if window:
        out["window"] = profiled_window(label, setup, state, dbatch, launches)
        check(out["window"]["kernel_events"] == {k: 2 * v for k, v in launches.items()},
              f"[{label}] window K1-K5 events {out['window']['kernel_events']}")
    del setup, state, dbatch
    out.pop("state")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def same_losses(label: str, a: dict, b: dict) -> None:
    """Step-0 loss terms of two arms within ``H_LOSS_RTOL``."""
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in LOSS_KEYS)
    print(f"[{label}] step-0 loss terms against H1's: largest relative difference "
          f"{worst:.3e} (tol {H_LOSS_RTOL:.0e}), bitwise "
          f"{all(a[k] == b[k] for k in LOSS_KEYS)}")
    check(worst <= H_LOSS_RTOL, f"[{label}] step-0 losses {a} vs H1's {b}")


def phase_h() -> dict:
    """The recipe as written (``configs/train/vitl16_im1k.yaml``: B=64,
    streaming Sinkhorn targets, K-tile 8192) and its options on the card."""
    import torch

    h1 = recipe_arm("H1", [], 5, STEP_LAUNCHES, profile=True)
    h2 = recipe_arm("H2", ["loss.streaming_targets=false"], 3, STEP_LAUNCHES, profile=True)
    same_losses("H2", h2["m0"], h1["m0"])
    print(f"[H2] materialized vs streaming targets at B=64: median {h2['median_ms']:.1f} vs "
          f"{h1['median_ms']:.1f} ms ({h2['median_ms'] / h1['median_ms']:.4f} x), peak "
          f"{h2['peak_gib']:.2f} vs {h1['peak_gib']:.2f} GiB "
          f"({h2['peak_gib'] - h1['peak_gib']:+.2f} GiB)")
    arms = {}
    for key, extra in (("blocks", ["train.checkpointing=true"]),
                       ("full", ["train.checkpointing_full=true"])):
        arms[key] = arm = recipe_arm(f"H3 {key}", extra, 3, REMAT_LAUNCHES)
        same_losses(f"H3 {key}", arm["m0"], h1["m0"])
        print(f"[H3] remat {key}: median {arm['median_ms']:.1f} ms "
              f"({arm['median_ms'] / h1['median_ms']:.4f} x H1), peak {arm['peak_gib']:.2f} GiB "
              f"({arm['peak_gib'] - h1['peak_gib']:+.2f} GiB)")
    h4 = recipe_arm("H4", ["optim.accum_steps=2"], 3,
                    {k: 2 * v for k, v in STEP_LAUNCHES.items()})
    print(f"[H4] accum_steps=2: median {h4['median_ms']:.1f} ms "
          f"({h4['median_ms'] / h1['median_ms']:.4f} x H1), peak {h4['peak_gib']:.2f} GiB "
          f"({h4['peak_gib'] - h1['peak_gib']:+.2f} GiB)")
    phase_h_targets()
    phase_h5()
    card_vs_cpu_step("H6", ["loss.streaming_targets=true", "loss.k_tile=1024",
                            "train.checkpointing=true", "optim.accum_steps=2"])
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(H_DIR, ignore_errors=True)
    os.makedirs(H_DIR)
    try:
        cli = run_cli("recipe", ["--output-dir", os.path.join(H_DIR, "run"),
                                 "--max-iterations", "4", "--benchmark", "2"],
                      base=RECIPE_OVERRIDES, label="H7", log_dir=H_DIR)
    finally:
        shutil.rmtree(H_DIR, ignore_errors=True)
    check(cli["launches"] == {k: 4 * v for k, v in STEP_LAUNCHES.items()},
          f"[H7] launches {cli['launches']}")
    check((cli["targets"], cli["remat"], cli["accum_steps"]) == ("streaming", "none", 1),
          f"[H7] resolved {cli}")
    check(np.isfinite(cli["final_loss"]), f"[H7] loss {cli['final_loss']}")
    print(f"[H7] CLI, the recipe as written: {cli['ms_per_step']:.1f} ms a step over 2 steps "
          f"({cli['img_per_sec']:.2f} img/s) against H1's median {h1['median_ms']:.1f} ms "
          f"({cli['ms_per_step'] / h1['median_ms']:.4f} x); peak {cli['peak_memory_gib']:.2f} GiB")
    return h1


def phase_h_targets() -> None:
    """Device time of the loss side at the recipe's B=64 shapes, the two
    target engines apart from the step: the iBOT rows (2B x M masked
    tokens by 65,536 prototypes, fp32 logits from the heads) and the DINO
    pairs (10 student crops x 2 teacher crops of B rows). Each engine's
    Sinkhorn targets (materialized q, or the factors) and its CE forward
    and backward, from the same seeded logits (cuda_ms, the mean of 3)."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.losses import ibot_loss_from_spec, pair_ce_from_spec, sinkhorn_knopp

    cfg = load_config(os.path.join(REPO, CLI_CONFIG), RECIPE_OVERRIDES, n_devices=1)
    B, K, k_tile = cfg.train.batch_size_per_device, cfg.ibot.head_n_prototypes, cfg.loss.k_tile
    batch = make_synthetic_batch(cfg, B, seed=0)
    valid = torch.from_numpy(batch["mask_valid"].reshape(-1)).cuda().float()
    weight = torch.from_numpy(batch["mask_weights"].reshape(-1)).cuda()
    rows = valid.numel()
    g = torch.Generator(device="cuda").manual_seed(0)
    s_rows = torch.randn(rows, K, device="cuda", generator=g).requires_grad_()
    t_rows = torch.randn(rows, K, device="cuda", generator=g)
    n_l = cfg.crops.local_crops_number
    s_cls = torch.randn(2 + n_l, B, K, device="cuda", generator=g).requires_grad_()
    t_cls = torch.randn(2 * B, K, device="cuda", generator=g)

    def targets(stream):
        qm = sinkhorn_knopp(t_rows, 0.07, row_weights=valid, return_factors=stream)
        qc = sinkhorn_knopp(t_cls, 0.07, return_factors=stream)
        if stream:
            return {"kind": "sinkhorn", "factors": qm}, {"kind": "sinkhorn", "factors": qc}
        return {"kind": "probs", "probs": qm}, {"kind": "probs", "probs": qc.reshape(2, B, K)}

    def ce(specs):
        ibot = ibot_loss_from_spec(s_rows, specs[0], weight, 2 * B, k_tile=k_tile)
        dino = pair_ce_from_spec(s_cls, specs[1], k_tile=k_tile).sum() / (B * 20)
        (ibot + dino).backward()
        s_rows.grad = s_cls.grad = None

    print(f"[H] loss side at B={B}: iBOT rows [{rows}, {K}], DINO pairs "
          f"[{2 + n_l} x 2, {B}, {K}], fp32 logits, K-tile {k_tile}")
    for stream in (True, False):
        with torch.no_grad():
            t_ms = cuda_ms(lambda: targets(stream), 3, warmup=1)
        specs = targets(stream)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        c_ms = cuda_ms(lambda: ce(specs), 3, warmup=1)
        extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"[H] {'streaming' if stream else 'materialized'} targets: Sinkhorn "
              f"{t_ms:.2f} ms, CE forward + backward {c_ms:.2f} ms, together "
              f"{t_ms + c_ms:.2f} ms; the CE's peak above its inputs {extra:.2f} GiB")
        del specs
    del s_rows, t_rows, s_cls, t_cls
    gc.collect()
    torch.cuda.empty_cache()


def phase_h5() -> None:
    """Softmax centering with bf16 targets, streaming: 2 steps, losses
    finite, both centers moved off zero."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup, put_batch

    cfg = load_config(os.path.join(REPO, CLI_CONFIG), RECIPE_OVERRIDES + [
        "train.centering=softmax_center", "compute_precision.target_dtype=bf16"], n_devices=1)
    B = cfg.train.batch_size_per_device
    batch = make_synthetic_batch(cfg, B, seed=0)
    setup = build_train_setup(cfg, batch, device="cuda", seed=0)
    check(setup.meta.streaming_targets and setup.meta.target_dtype == torch.bfloat16,
          "[H5] not streaming bf16 targets")
    dbatch = put_batch(batch, "cuda")
    state = setup.state
    for i in range(2):
        state, m = setup.step_fn(state, dbatch, setup.scalars(i))
        check(all(np.isfinite(m[k]) for k in LOSS_KEYS), f"[H5] non-finite loss {m}")
    norms = {k: float(c.abs().sum()) for k, c in state.center_state.items()}
    print(f"[H5] softmax centering, bf16 targets, B={B}: step 1 " +
          ", ".join(f"{k} {m[k]:.4f}" for k in LOSS_KEYS) + f"; |center| sums {norms}")
    check(all(v > 0 and np.isfinite(v) for v in norms.values()), f"[H5] centers {norms}")
    del setup, state, dbatch
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase I

I_DIR = os.path.join(REPO, "build", "phase_i")
# phase G's uninterrupted run hands its step-4 checkpoint over here
I_CKPT = os.path.join(I_DIR, "ckpt")
EVAL_B = 256
EVAL_PX = 224
# launches of one feature batch of the ViT-L/16 forward: K1 once a block,
# K4 twice a block and the final norm
EVAL_LAUNCHES = {"K1": 24, "K2": 0, "K3": 0, "K4": 49, "K5": 0}
# and of the CLI_DEPTH-block model of phase G's checkpoint (phase I5)
CLI_EVAL_LAUNCHES = {"K1": CLI_DEPTH, "K2": 0, "K3": 0, "K4": 2 * CLI_DEPTH + 1, "K5": 0}
# ImageNet-1k's split lengths (dinov3_tpu/data/datasets/image_net.py) and
# classes, at the ViT-L/16 width
IN1K_TRAIN, IN1K_VAL, IN1K_CLASSES, EVAL_DIM = 1_281_167, 50_000, 1000, 1024
# in-run eval sets of phase I5: do_eval's batch of 64 takes 2 train and 1
# val feature batches
I5_SETS = ["evaluation.train_dataset_path=Synthetic:split=TRAIN:size=128:image_size=256:"
           "n_classes=10",
           "evaluation.val_dataset_path=Synthetic:split=VAL:size=64:image_size=256:"
           "n_classes=10"]
I5_FEATURE_BATCHES = 3


def forward_flops(model, n_tokens: int) -> float:
    """Operations of one image through a ViT forward, counted from its
    modules (two a multiply-add): every Linear of the blocks over each
    token (qkv, proj and the MLP or SwiGLU), attention's 4 N^2 d a head a
    block, the patch embedding."""
    from torch import nn

    D, p = model.embed_dim, model.patch_size
    linear = sum(m.weight.numel() for m in model.blocks.modules() if isinstance(m, nn.Linear))
    return (2 * linear * n_tokens + model.n_blocks * 4 * n_tokens ** 2 * D
            + 2 * (n_tokens - model.n_prefix) * p * p * model.in_chans * D)


def extract_timed(label: str, model, flops: float, batches: list, want: dict) -> dict:
    """``extract_features`` over host batches of EVAL_B images at EVAL_PX
    (in memory before the clock starts: loading is set-up; pinned copies,
    one read-back a batch, synchronized), the first a warm-up (library
    handles, allocator) that runs again at the end and must give its
    features bit for bit: img/s, the share of the bf16 tensor-core cap
    from the forward's counted operations, peak memory, the launches
    pinned a batch (``want``), finite float32 features and a label an
    image."""
    import torch

    from dinov3_tpu_torch.evals import extract_features

    warm, _ = extract_features(model, iter(batches[:1]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    feats, labels = extract_features(model, iter(batches[1:]))
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_batches = len(batches) - 1
    n_img = n_batches * EVAL_B
    img_s = n_img / wall
    cap = BF16_TC_FLOP_S / flops
    print(f"[{label}] extract_features: {n_img} images in {wall * 1e3:.1f} ms "
          f"({wall / n_batches * 1e3:.1f} ms a batch of {EVAL_B}): {img_s:.1f} img/s; "
          f"{flops / 1e9:.1f} GFLOP an image ({flops * EVAL_B / 1e15:.4f} PFLOP a batch) "
          f"caps the card at {cap:.0f} img/s, share {img_s / cap:.4f}; peak {peak:.2f} GiB; "
          f"launches {launches}")
    check(feats.shape == (n_img, model.embed_dim) and feats.dtype == np.float32
          and np.isfinite(feats).all() and labels.shape == (n_img,),
          f"[{label}] bad features {feats.shape}")
    pinned = {k: v * n_batches for k, v in want.items()}
    check(launches == pinned, f"[{label}] launches {launches} != {pinned}")
    again, _ = extract_features(model, iter(batches[:1]))
    check(np.array_equal(warm, again), f"[{label}] two extractions of one batch differ")
    return {"launches": launches, "batches": n_batches, "img_s": img_s,
            "share": img_s / cap, "peak_gib": peak, "gflop_per_img": flops / 1e9,
            "ms_per_batch": wall / n_batches * 1e3}


def seeded_batches(n: int) -> list:
    """n host batches of EVAL_B seeded normal images at EVAL_PX."""
    rng = np.random.default_rng(23)
    return [{"image": rng.standard_normal((EVAL_B, EVAL_PX, EVAL_PX, 3), np.float32),
             "label": np.zeros(EVAL_B, np.int64)} for _ in range(n)]


def device_busy(fn, label: str, top: int = 8) -> dict:
    """Wall and device-busy ms of one run of fn() under torch.profiler
    (device-side events only), its idle share, its device time by kernel
    class and its top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"[{label}] profile: no device events recorded (device time not measured)")
        return {"wall_ms": wall}
    by_name: dict = {}
    for e in events:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy = sum(t for _, t in by_name.values())
    buckets = dict.fromkeys(("K1", "K4", "gemm", "memcpy", "elementwise/other"), 0.0)
    for name, (_, t) in by_name.items():
        low = name.lower()
        key = ("K1" if "flash_fwd" in low else "K4" if "layernorm_fwd" in low
               else "gemm" if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet"))
               else "memcpy" if "memcpy" in low or "memset" in low else "elementwise/other")
        buckets[key] += t
    print(f"[{label}] profile: wall {wall:.2f} ms (tracer on), device busy {busy:.2f} ms, "
          f"idle share {max(0.0, 1 - busy / wall):.3f}; " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in buckets.items()))
    for name, (n, t) in sorted(by_name.items(), key=lambda r: -r[1][1])[:top]:
        print(f"[{label}]   {t:9.3f} ms  x{n:<5d} {name[:90]}")
    return {"wall_ms": wall, "busy_ms": busy}


def host_batches(dataset_str: str, transform, n_batches: int, seed: int = 0) -> list:
    """The first n_batches batches of EVAL_B images of the eval harness's
    loader (threads, epoch sampler, collate), collected on the host."""
    from dinov3_tpu_torch.evals.harness import _loader

    loader, _ = _loader(dataset_str, transform, EVAL_B, 8, seed, None)
    batches = iter(loader)
    try:
        return list(itertools.islice(batches, n_batches))
    finally:
        batches.close()


def phase_i(cfg, g_step_ms: list) -> dict:
    """The evaluation path at ViT-L/16 (module docstring); ``g_step_ms``:
    phase G's ``--benchmark`` step times, the band of phase I5's."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    check(os.path.isdir(I_CKPT), f"[I] phase G's checkpoint is not under {I_CKPT}")
    try:
        out = phase_i1(cfg)
        phase_i2(cfg)
        out["i3"] = phase_i3()
        phase_i4(cfg)
        phase_i5(g_step_ms)
    finally:
        shutil.rmtree(I_DIR, ignore_errors=True)
    return out


def phase_i1(cfg) -> dict:
    """Feature extraction: seeded ViT-L/16 weights, synthetic 256 px images
    through the eval transform at 224 px, batches of 256."""
    import torch

    from dinov3_tpu_torch.data.transforms import make_classification_eval_transform
    from dinov3_tpu_torch.evals import make_feature_fn
    from dinov3_tpu_torch.models import build_model_for_eval

    t0 = time.perf_counter()
    model = build_model_for_eval(cfg, device="cuda", seed=0)
    print(f"[I1] eval model (seeded ViT-L/16 teacher backbone, fp32 parameters, bf16 compute): "
          f"{model.n_blocks} blocks, width {model.embed_dim}; built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(model.n_blocks == 24 and model.embed_dim == 1024 and model.n_prefix == 1,
          "[I1] not the ViT-L/16 slice")
    n_batches = 4
    t0 = time.perf_counter()
    batches = host_batches("Synthetic:split=TRAIN:size=100000:image_size=256",
                           make_classification_eval_transform(256, EVAL_PX), n_batches + 1)
    host_s = time.perf_counter() - t0
    print(f"[I1] host pipeline (8 threads: synthetic 256 px images, resize, centre crop "
          f"224, normalize, collate): {(n_batches + 1) * EVAL_B} images in {host_s:.2f} s, "
          f"{(n_batches + 1) * EVAL_B / host_s:.1f} img/s")
    check(batches[0]["image"].shape == (EVAL_B, EVAL_PX, EVAL_PX, 3), "[I1] batch shape")
    out = extract_timed("I1", model, forward_flops(model, 1 + (EVAL_PX // 16) ** 2), batches,
                        EVAL_LAUNCHES)
    feat = make_feature_fn(model)
    x = torch.from_numpy(batches[1]["image"]).to("cuda")
    device_busy(lambda: feat(x), "I1 one batch")
    del x

    # K1 and K4 at the eval shapes: q, k, v of one block's qkv projection
    # ([256, 197, 3 x 1024] bf16, v a view), and the block input rows
    g = torch.Generator().manual_seed(0)
    N, H, D = 1 + (EVAL_PX // 16) ** 2, 16, 64
    qkv = torch.randn(EVAL_B, N, 3 * H * D, generator=g).to("cuda", torch.bfloat16)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(EVAL_B, N, H, D) for i in range(3))
    k1 = check_flash(q.contiguous(), k.contiguous(), v, None,
                     f"eval [{EVAL_B}x{H}, {N}, {D}] bf16 no seg", time_it=True)
    del qkv, q, k, v
    xr = (torch.randn(EVAL_B * N, 1024, generator=g) * 3 + 1).to("cuda", torch.bfloat16)
    s, b = torch.randn(1024, generator=g) * 0.5 + 1, torch.randn(1024, generator=g)
    k4 = check_layernorm(xr, s.to("cuda"), b.to("cuda"),
                         f"eval rows [{EVAL_B * N}, 1024] bf16, fp32 params", time_it=True)
    del xr, model
    return {**out, "K1": k1, "K4": k4}


def phase_i2(cfg) -> None:
    """The features and intermediate layers of 8 images through a 2-block
    ViT-L-width model (LayerScale 1, as phase D) on the card and on the
    CPU, from the same fp32 weights."""
    import torch

    from dinov3_tpu_torch.configs import apply_dot_overrides
    from dinov3_tpu_torch.evals import extract_features
    from dinov3_tpu_torch.models import backbone_kwargs_from_cfg, vit_large

    cfg = copy.deepcopy(cfg)
    apply_dot_overrides(cfg, ["student.layerscale=1.0"])
    model = vit_large(**backbone_kwargs_from_cfg(cfg), n_blocks=2)
    model.init_weights(torch.Generator().manual_seed(6))
    model = model.eval().requires_grad_(False)
    images = np.random.default_rng(7).standard_normal(
        (8, EVAL_PX, EVAL_PX, 3)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        t0 = time.perf_counter()
        feats, _ = extract_features(m, iter([{"image": images, "label": np.arange(8)}]))
        with torch.inference_mode():
            layers = m.get_intermediate_layers(torch.from_numpy(images).to(dev), [0, 1],
                                               return_class_token=True)
        out[dev] = [feats] + [t.float().cpu().numpy() for pair in layers for t in pair]
        print(f"[I2] 8 images on {dev}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    # phase D's tolerance: 2^-4 of the magnitude (two bf16 blocks whose
    # matmuls sum in other orders, K1's bf16 probabilities)
    names = ["features", "block 0 patches", "block 0 cls", "block 1 patches", "block 1 cls"]
    for name, a, b in zip(names, out["cuda"], out["cpu"]):
        check(a.shape == b.shape and np.isfinite(a).all(), f"[I2] {name}: bad output")
        err = float(np.abs(a - b).max())
        tol = 2.0 ** -4 * max(float(np.abs(b).max()), 1.0)
        print(f"[I2] card vs CPU {name} {tuple(a.shape)}: max error {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"[I2] {name}: card vs CPU {err:.3e} > {tol:.3e}")


def in1k_features(gen, n: int, centers, spread: float):
    """n seeded class-structured fp32 rows on the card: a class's unit
    center plus Gaussian noise, classes drawn uniformly."""
    import torch

    labels = torch.randint(0, IN1K_CLASSES, (n,), generator=gen, device="cuda")
    x = torch.randn(n, EVAL_DIM, generator=gen, device="cuda").mul_(spread)
    return x.add_(centers[labels]), labels


def phase_i3() -> dict:
    """k-NN (k = 10, 20) and one epoch of the 8-lr probe sweep at
    ImageNet-1k's sizes, on seeded class-structured features made on the
    card; a 20k/5k subset on the card against the CPU."""
    import torch

    from dinov3_tpu_torch.evals import knn_eval_multi, linear_probe_sweep
    from dinov3_tpu_torch.evals.knn import knn_predict
    from dinov3_tpu_torch.evals.linear import epoch_orders, train_probes

    gen = torch.Generator(device="cuda").manual_seed(11)
    centers = torch.randn(IN1K_CLASSES, EVAL_DIM, generator=gen, device="cuda")
    centers /= centers.norm(dim=1, keepdim=True)
    tx, ty = in1k_features(gen, IN1K_TRAIN, centers, 0.05)
    vx, vy = in1k_features(gen, IN1K_VAL, centers, 0.05)
    torch.cuda.synchronize()
    print(f"[I3] features: train {tuple(tx.shape)}, val {tuple(vx.shape)} fp32, "
          f"{IN1K_CLASSES} classes, on the card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    knn = knn_eval_multi(tx, ty, vx, vy, IN1K_CLASSES, device="cuda")
    knn_s = time.perf_counter() - t0
    knn_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the similarity products in fp32: 2 N_val N_train d operations
    sim_ops = 2.0 * IN1K_VAL * IN1K_TRAIN * EVAL_DIM
    print(f"[I3] knn_eval_multi (k = 10, 20; one pass, chunks of 1024 queries): "
          f"{knn_s:.3f} s, peak {knn_peak:.2f} GiB; {knn}; similarity products "
          f"{sim_ops / 1e12:.1f} TFLOP, {sim_ops / FP32_FLOP_S:.3f} s at the fp32 peak")
    check(min(knn.values()) > 0.9, f"[I3] k-NN top-1 {knn} on separable features")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    best, grid = linear_probe_sweep(tx, ty, vx, vy, IN1K_CLASSES, epochs=1, device="cuda")
    sweep_s = time.perf_counter() - t0
    sweep_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = IN1K_TRAIN // 256
    print(f"[I3] linear_probe_sweep, 8 lrs, 1 epoch of {steps} steps of 256 rows: "
          f"{sweep_s:.3f} s ({sweep_s / steps * 1e3:.4f} ms a step), peak {sweep_peak:.2f} "
          f"GiB; best {best:.4f}; {grid}")
    check(best > 0.9, f"[I3] best probe top-1 {best} on separable features")
    # how much of a probe step is the host's: 200 steps profiled
    sub = epoch_orders(200 * 256, 1, seed=0)
    device_busy(lambda: train_probes(tx[:200 * 256], ty[:200 * 256], IN1K_CLASSES,
                                     [1e-3] * 8, [0.0] * 8, epochs=1, orders=sub,
                                     device="cuda"), "I3 200 probe steps")
    device_busy(lambda: knn_predict(tx, ty, vx[:4096], IN1K_CLASSES, (10, 20),
                                    device="cuda"), "I3 k-NN, 4 chunks")

    # the card against the CPU on a 20k / 5k subset
    stx, sty, svx, svy = (t.cpu() for t in (tx[:20_000], ty[:20_000], vx[:5_000], vy[:5_000]))
    del tx, ty, vx, vy
    preds = {dev: knn_predict(stx, sty, svx, IN1K_CLASSES, (10, 20), device=dev)
             for dev in ("cuda", "cpu")}
    for k in (10, 20):
        same = int((preds["cuda"][k] == preds["cpu"][k]).sum())
        print(f"[I3] k-NN k={k} on 20k/5k: card and CPU predictions equal on {same} of 5000")
        check(same == 5000, f"[I3] k-NN k={k}: card and CPU predictions differ")
    sweeps = {dev: linear_probe_sweep(stx, sty, svx, svy, IN1K_CLASSES, epochs=1, device=dev)[1]
              for dev in ("cuda", "cpu")}
    worst = max(abs(sweeps["cuda"][c] - sweeps["cpu"][c]) * 5000 for c in sweeps["cpu"])
    print(f"[I3] sweep on 20k/5k: card {sweeps['cuda']}; CPU {sweeps['cpu']}; largest "
          f"difference {worst:.0f} samples")
    check(worst <= 1 + 1e-6, f"[I3] sweep: card and CPU differ by {worst} samples")
    return {"knn_s": knn_s, "knn_peak_gib": knn_peak, "sweep_epoch_s": sweep_s,
            "sweep_peak_gib": sweep_peak}


def phase_i4(cfg) -> None:
    """``python -m dinov3_tpu_torch.evals`` on phase G's checkpoint, in a
    child process with a time limit, over 2048 / 512 synthetic images."""
    import torch

    from dinov3_tpu_torch.models import build_model_for_eval

    cmd = [sys.executable, "-m", "dinov3_tpu_torch.evals", "--ckpt", I_CKPT,
           "--config-file", CLI_CONFIG, "--batch-size", str(EVAL_B), "--probe-epochs", "2",
           "--output", os.path.join(I_DIR, "eval.json"),
           "evaluation.train_dataset_path=Synthetic:split=TRAIN:size=2048:image_size=256:"
           "n_classes=10",
           "evaluation.val_dataset_path=Synthetic:split=VAL:size=512:image_size=256:"
           "n_classes=10", "train.num_workers=8", f"+student.n_blocks={CLI_DEPTH}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    with open(os.path.join(I_DIR, "eval_cli.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tail = (proc.stdout + proc.stderr).splitlines()[-40:]
        raise SmokeFailure(f"[I4] eval CLI: exit {proc.returncode}\n" + "\n".join(tail))
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[I4] eval CLI on the step-4 checkpoint: {wall:.1f} s wall; {results}")
    check({"knn10_top1", "knn20_top1", "knn_top1", "linear_top1", "linear_sweep"}
          <= set(results) and len(results["linear_sweep"]) == 8, f"[I4] results {results}")
    check(all(0.0 <= v <= 1.0 for v in (results["knn_top1"], results["linear_top1"])),
          f"[I4] results {results}")
    with open(os.path.join(I_DIR, "eval.json")) as f:
        check(json.load(f) == results, "[I4] --output differs from the printed line")
    model = build_model_for_eval(ckpt_cfg(cfg), I_CKPT, device="cuda")
    want = teacher_of(I_DIR, 4)
    got = model.state_dict()
    bad = [k for k, v in got.items() if not torch.equal(v.cpu(), want[f"backbone.{k}"])]
    check(not bad and len(got) == sum(k.startswith("backbone.") for k in want),
          f"[I4] restored teacher differs from the checkpoint's: {bad[:5]}")
    print(f"[I4] build_model_for_eval: the EMA teacher backbone of step 4, {len(got)} "
          f"tensors, bitwise the checkpoint's")
    del model, want, got


def phase_i5(g_step_ms: list) -> None:
    """Evals inside a trainer CLI run at ViT-L/16 width and phase G's depth,
    B=32: 3 iterations, an eval after the second (inside a --benchmark
    interval), one save."""
    result = run_cli("in-run eval", ["--output-dir", os.path.join(I_DIR, "run"),
                                     "--max-iterations", "3", "--benchmark", "2"],
                     ["checkpointing.period=100", "evaluation.eval_period_iterations=2",
                      "train.num_workers=8", *I5_SETS], label="I5", log_dir=I_DIR)
    with open(os.path.join(I_DIR, "run", "evals.json")) as f:
        records = [json.loads(line) for line in f]
    print(f"[I5] evals.json {records}; eval {result['evals'][0]['seconds']:.2f} s; "
          f"--benchmark steps " + ", ".join(f"{t:.1f}" for t in result["step_ms"]) + " ms")
    check([r["iteration"] for r in records] == [2] and len(result["evals"]) == 1,
          f"[I5] eval records {records}")
    want = {k: 3 * v + I5_FEATURE_BATCHES * CLI_EVAL_LAUNCHES[k]
            for k, v in CLI_STEP_LAUNCHES.items()}
    check(result["launches"] == want, f"[I5] launches {result['launches']} != {want}")
    check(np.isfinite(result["final_loss"]), f"[I5] loss {result['final_loss']}")
    lo, hi = min(g_step_ms), max(g_step_ms)
    check(all(0.9 * lo <= t <= 1.1 * hi for t in result["step_ms"]),
          f"[I5] step times {result['step_ms']} outside phase G's band "
          f"[0.9 x {lo:.1f}, 1.1 x {hi:.1f}] ms")
    print(f"[I5] step times within phase G's band ({lo:.1f}-{hi:.1f} ms, 10 % each way)")


# ---------------------------------------------------------------- phase J

J_DIR = os.path.join(REPO, "build", "phase_j")
# measured requests of each serving-plane draw (and as many warm-up ones):
# 256 until phase N joined the smoke, 128 since, for the time limit (PERF.md §5)
J_N = 128
J_SLOS = ("interactive", "batch")
# launches of one ViT-L/16 forward: a packed pack (K4 adds the CLS norm
# applied beside the patch norm) and a plain forward of the oracles
PACK_LAUNCHES = {"K1": 24, "K2": 0, "K3": 0, "K4": 50, "K5": 0}
FORWARD_LAUNCHES = {"K1": 24, "K4": 49}


def close_features(label: str, got: dict, want: dict) -> float:
    """Per request, CLS and pooled features within 2^-5 of the reference's
    magnitude (phase C's tolerance); the worst error as a share of it."""
    check(sorted(got) == sorted(want), f"[{label}] other requests")
    worst = 0.0
    for i, w in want.items():
        for name in ("cls_feature", "pooled_patch_feature"):
            a, b = getattr(got[i], name), getattr(w, name)
            tol = 2.0 ** -5 * max(float(np.abs(b).max()), 1.0)
            err = float(np.abs(a - b).max())
            check(np.isfinite(a).all() and err <= tol,
                  f"[{label}] request {i} {name}: {err:.3e} > {tol:.3e}")
            worst = max(worst, err / tol)
    return worst


def hist_within_a_bucket(label: str, obs_slo: dict, exact_slo: dict) -> None:
    """Each SLO class's streaming-histogram p50/p99 within one bucket width
    (a ratio) of the exact nearest-rank values of the same replay."""
    for slo, exact in exact_slo.items():
        h = obs_slo[slo]
        check(h["n"] == exact["n"], f"[{label}] {slo}: histogram n {h['n']} != {exact['n']}")
        for q in ("p50", "p99"):
            ratio = h[q] / exact[f"{q}_ms"]
            check(1 / h["width_factor"] <= ratio <= h["width_factor"],
                  f"[{label}] {slo} {q}: histogram {h[q]:.3f} vs exact "
                  f"{exact[f'{q}_ms']:.3f} ms")


def lat_line(lat: dict) -> str:
    return (f"p50 {lat['p50_ms']:.2f} / p99 {lat['p99_ms']:.2f} ms (n {lat['n']}); "
            + "; ".join(f"{slo} p50 {v['p50_ms']:.2f} / p99 {v['p99_ms']:.2f} ms (n {v['n']})"
                        for slo, v in lat["by_slo"].items()))


def phase_j(cfg) -> dict:
    """The serving plane at ViT-L/16 on the card, through
    ``dinov3_tpu_torch/serve/bench.py``'s functions: the three arms (J1),
    int8 against bf16 (J2), the fleet with the cache (J3), the entry
    points (J4) and K1 at the oracle's dense shapes (J5). Returns its
    counted launches and K1's oracle rows."""
    import torch

    from dinov3_tpu_torch.serve import load_serving_model, serve_layout_from_cfg

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(J_DIR, ignore_errors=True)
    os.makedirs(J_DIR)
    t0 = time.perf_counter()
    model = load_serving_model(cfg, device="cuda", seed=0)
    layout = serve_layout_from_cfg(cfg)
    check(model.n_blocks == 24 and model.embed_dim == 1024 and model.num_heads == 16
          and (layout.rows, layout.row_tokens, layout.max_segments_per_row) == (4, 2050, 8),
          "[J] not the ViT-L/16 serving slice")
    print(f"[J] ViT-L/16 bf16 serving model built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(7)
    warm = make_mix(rng, MIXED_RAGGED, J_N, layout.patch_size)
    meas = make_mix(rng, MIXED_RAGGED, J_N, layout.patch_size)
    try:
        out = {"launches": phase_j1(cfg, model, layout, warm, meas, rng)}
        phase_j2(model, layout, warm, meas)
        phase_j3(cfg, model, layout, warm, meas, rng)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        phase_j4(cfg)
        out["k1_oracle"] = phase_j5()
    finally:
        shutil.rmtree(J_DIR, ignore_errors=True)
    print(f"[J] serving plane done in {time.perf_counter() - t0:.1f} s")
    return out


def phase_j1(cfg, model, layout, warm, meas, rng) -> dict:
    """Three arms over identical traffic: sustained img/s, the rated
    replay at 0.7 x the packed rate (exact p50/p99 overall and per SLO
    class, the histograms within a bucket), features, compile counts,
    fetches and synchronizing calls a pack, launches."""
    import torch

    from dinov3_tpu_torch.configs.config import serve_obs_kwargs
    from dinov3_tpu_torch.serve import OracleServeEngine, PackedServeEngine
    from dinov3_tpu_torch.serve.bench import (
        _serve_summary,
        drain_all,
        measure_arm,
    )
    from dinov3_tpu_torch.telemetry import ServeObserver, SpanTracer

    engines = {"packed": PackedServeEngine(model, layout, warn=False),
               "oracle_rectangular": OracleServeEngine(model, layout),
               "oracle_per_image": OracleServeEngine(model, layout, mode="per_image")}
    packed = engines["packed"]
    drain_all(packed, warm)
    wall, _ = drain_all(packed, warm)
    rate = 0.7 * J_N / wall
    trace = [(float(a), im) for a, im in
             zip(np.cumsum(rng.exponential(1.0 / rate, J_N)), meas)]
    print(f"[J1] mixed_ragged, {J_N} requests a draw: packed probe "
          f"{J_N / wall:.2f} img/s; rated replay offered at {rate:.2f} img/s")
    tracer = SpanTracer(J_DIR, role="serve")
    recs, responses, counted = {}, {}, {}
    for arm, eng in engines.items():
        obs = ServeObserver(tracer, layout, slo_classes=J_SLOS, **serve_obs_kwargs(cfg))
        obs.set_labels(arm=arm, mix="mixed_ragged")
        packs0 = eng.packs_run
        torch.cuda.synchronize()
        reset_counts()
        rec, resp = measure_arm(eng, warm, meas, trace, _serve_summary,
                                lambda w: None, observer=obs)
        counted[arm] = read_counts()
        recs[arm], responses[arm] = rec, {r.request_id: r for r in resp}
        serve = rec["serve"]
        print(f"[J1] {arm}: {rec['throughput']['images_per_s']:.2f} img/s "
              f"({rec['throughput']['wall_s']:.3f} s drain); rated "
              f"{lat_line(rec['latency'])}; compile_count {serve['compile_count']} "
              f"(+{rec['compile_growth_during_measurement']} while measured, "
              f"{rec['novel_shapes_after_warmup']} novel shapes); pad waste "
              f"{serve['pad_waste']}; fetches {serve['host_sync']['fetches']} "
              f"({serve['host_sync']['blocked_ms']:.1f} ms blocked) over "
              f"{serve['obs']['packs']} packs; launches {counted[arm]}")
        hist_within_a_bucket(f"J1 {arm}", serve["obs"]["slo"], rec["latency"]["by_slo"])
        print(f"[J1] {arm}: histogram p50/p99 " + "; ".join(
            f"{slo} {h['p50']:.2f} / {h['p99']:.2f} ms" for slo, h in serve["obs"]["slo"].items()
            if h["n"]) + " (within one bucket width of the exact values)")
        if arm == "packed":
            packs = eng.packs_run - packs0
            check(serve["compile_count"] == 1, "[J1] packed compile_count != 1")
            check(serve["host_sync"]["fetches"] == serve["obs"]["packs"],
                  f"[J1] packed: {serve['host_sync']} for {serve['obs']['packs']} packs")
            want = {k: v * packs for k, v in PACK_LAUNCHES.items()}
            check(counted[arm] == want, f"[J1] packed launches {counted[arm]} != {want}")
        else:
            k1, k4 = counted[arm]["K1"], counted[arm]["K4"]
            check(k1 > 0 and k1 % 24 == 0 and k4 * 24 == k1 * 49
                  and counted[arm]["K2"] == counted[arm]["K3"] == counted[arm]["K5"] == 0,
                  f"[J1] {arm} launches {counted[arm]}: not whole forwards")
            print(f"[J1] {arm}: {k1 // 24} forwards, "
                  f"{serve['host_sync']['fetches']} fetches")
    tracer.close()
    worst = close_features("J1 packed vs oracle_per_image", responses["packed"],
                           responses["oracle_per_image"])
    rect = close_features("J1 oracle_rectangular vs oracle_per_image",
                          responses["oracle_rectangular"], responses["oracle_per_image"])
    print(f"[J1] packed vs oracle_per_image over {J_N} requests: worst "
          f"{worst:.3f} of the tolerance; rectangular vs per-image {rect:.3f}")
    for arm in ("oracle_rectangular", "oracle_per_image"):
        print(f"[J1] packed / {arm}: x{recs['packed']['throughput']['images_per_s'] / recs[arm]['throughput']['images_per_s']:.3f} img/s")
    # the synchronizing calls of one packed pack, as phase E counts them
    for i, im in enumerate(meas[:64]):
        packed.submit(im, request_id=i)
    sites, served = sync_sites(packed.flush)
    while packed.queue_len:
        packed.flush()
    print(f"[J1] synchronizing calls in one pack ({len(served)} requests): "
          f"{sum(sites.values())}" + "".join(f"; {n} x {s}" for s, n in sites.most_common(6)))
    check(sum(sites.values()) == 1, f"[J1] a pack synchronizes {dict(sites)}")
    # where an oracle forward's time goes: host-bound dispatch or device
    for arm in ("oracle_per_image", "oracle_rectangular"):
        def run(eng=engines[arm]):
            for i, im in enumerate(meas[:32]):
                eng.submit(im, request_id=i)
            eng.flush()
        device_busy(run, f"J1 {arm} 32 requests")
    device_busy(lambda: drain_all(packed, meas[:64]), "J1 packed 64 requests")
    return {k: sum(c[k] for c in counted.values()) for k in KERNELS}


def phase_j2(model, layout, warm, meas) -> None:
    """int8 against bf16, packed, on one draw: resident bytes, drift,
    best of 3 alternated drains, feature agreement."""
    import torch

    from dinov3_tpu_torch.serve import (
        PackedServeEngine,
        quant_feature_drift,
        quant_summary,
        quantize_serving_model,
    )
    from dinov3_tpu_torch.serve.bench import drain_all, feature_agreement

    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    qmodel = quantize_serving_model(model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - a0
    qs, bs = quant_summary(qmodel), quant_summary(model)
    print(f"[J2] int8 model built in {build_s:.1f} s (host quantization): "
          f"{qs['quantized_kernels']} int8 weights; resident on the card {resident} B "
          f"against quant_summary weight_bytes {qs['weight_bytes']} and the bf16 "
          f"model's {bs['weight_bytes']} B: {resident / bs['weight_bytes']:.4f} "
          f"(bytes_ratio {qs['bytes_ratio']})")
    # the allocator does not split a block whose remainder is under 1 MiB,
    # so ~100 weights of 1-4 MiB hold a few MiB more than their bytes; a
    # dense bf16 copy left on the card would add about 600 MB
    check(qs["weight_bytes"] <= resident <= 1.02 * qs["weight_bytes"],
          f"[J2] resident {resident} B vs weight_bytes {qs['weight_bytes']}")
    check(qs["bytes_ratio"] < 0.55, f"[J2] bytes_ratio {qs['bytes_ratio']}")
    drift = quant_feature_drift(model, qmodel, px=224)
    print(f"[J2] drift probe at 224 px: {drift}")
    check(drift["cls_max_abs_diff"] <= 0.05, f"[J2] int8 drift {drift}")
    eng = {"bf16": PackedServeEngine(model, layout, warn=False),
           "int8": PackedServeEngine(qmodel, layout, warn=False)}
    check(eng["int8"].arm == "packed_int8", "[J2] int8 arm")
    for e in eng.values():
        drain_all(e, warm)
    best, resp, counted = {}, {}, {}
    for _ in range(3):
        for name, e in eng.items():
            packs0 = e.packs_run
            reset_counts()
            wall, rs = drain_all(e, meas)
            counted[name] = (read_counts(), e.packs_run - packs0)
            best[name] = max(best.get(name, 0.0), J_N / wall)
            resp[name] = rs
    agree = feature_agreement(resp["bf16"], resp["int8"])
    for name, (c, packs) in counted.items():
        check(c == {k: v * packs for k, v in PACK_LAUNCHES.items()},
              f"[J2] {name} launches {c} over {packs} packs")
    print(f"[J2] best of 3 drains: bf16 {best['bf16']:.2f} img/s, int8 "
          f"{best['int8']:.2f} img/s (int8/bf16 {best['int8'] / best['bf16']:.4f}); "
          f"features int8 vs bf16 {agree}")
    del eng, qmodel


def phase_j3(cfg, model, layout, warm, meas, rng) -> None:
    """The fleet: an int8 fast lane for interactive traffic on the
    envelope a LiveMixTracker derives from the warm draw, beside the bf16
    row, the cache in front; a rated replay at a hit rate of 0.5 with the
    cache audited bitwise."""
    import torch

    from dinov3_tpu_torch.configs.config import serve_obs_kwargs
    from dinov3_tpu_torch.serve import build_serve_fleet
    from dinov3_tpu_torch.serve.bench import (
        derive_fast_envelope,
        fleet_drain,
        fleet_engines_from_envelope,
        fleet_rated_replay,
        repeat_trace,
    )
    from dinov3_tpu_torch.telemetry import ServeObserver

    env = derive_fast_envelope(warm, layout)
    fcfg = copy.deepcopy(cfg)
    fcfg.serve.fleet.engines = fleet_engines_from_envelope(env)
    t0 = time.perf_counter()
    router = build_serve_fleet(fcfg, model.state_dict(), device="cuda", warn=False)
    print(f"[J3] fleet built in {time.perf_counter() - t0:.1f} s: " + ", ".join(
        f"{s.name} ({s.engine.arm}, {s.engine.layout.rows} x {s.engine.layout.row_tokens}, "
        f"{s.engine.layout.max_segments_per_row} slots, slo {s.slo_classes})"
        for s in router.specs) + f"; drift probe {router.quant_drift}")
    check(router.compile_count == len(router.specs) == 2, "[J3] compile count")
    check(router.specs[0].engine.model is not router.specs[1].engine.model
          and router.specs[0].fingerprint != router.specs[1].fingerprint,
          "[J3] the int8 and bf16 engines share a model")
    router.observer = ServeObserver(None, layout, slo_classes=(), **serve_obs_kwargs(cfg))
    wall, _ = fleet_drain(router, warm, layout)
    rate = 0.7 * J_N / wall
    router.cache.clear(reset_counters=True)
    seq = repeat_trace(rng, meas, J_N, 0.5)
    trace = [(float(a), im) for a, im in zip(np.cumsum(rng.exponential(1.0 / rate, J_N)), seq)]
    responses, audit = fleet_rated_replay(router, trace, layout)
    stats = router.cache.stats()
    fin = router.finalize()
    by_key: dict = {}
    for r in responses:
        by_key.setdefault(f"{r.engine}/{r.slo}", []).append(r.latency_s)
    from dinov3_tpu_torch.serve.bench import _lat_summary

    print(f"[J3] cold-cache fleet drain {J_N / wall:.2f} img/s; replay at {rate:.2f} img/s, "
          f"hit rate 0.5: measured {stats['hit_rate']}, {audit['hits']} hits, "
          f"{audit['bitwise_failures']} not bitwise their miss; routes {fin['route_counts']}; "
          f"compile_count_total {fin['compile_count_total']}")
    for key, lats in sorted(by_key.items()):
        s = _lat_summary(lats)
        print(f"[J3]   {key}: p50 {s['p50_ms']:.2f} / p99 {s['p99_ms']:.2f} ms (n {s['n']})")
    check(len(responses) == J_N and audit["hits"] > 0 and audit["bitwise_failures"] == 0,
          f"[J3] cache audit {audit}")
    check(fin["compile_count_total"] == fin["n_engines"] == 2, f"[J3] {fin}")
    del router
    gc.collect()
    torch.cuda.empty_cache()


def phase_j4(cfg) -> None:
    """The entry points: ``build_serve_engine(cfg, ckpt_dir=...)`` on
    phase G's step-4 checkpoint, bitwise the engine over
    ``load_serving_model(cfg, ckpt_dir=...)``; ``continuous_packing=false``
    builds the oracle ``serve.oracle`` names; the bench CLI's smoke on the
    card as a child process."""
    import torch

    from dinov3_tpu_torch.configs import apply_dot_overrides
    from dinov3_tpu_torch.serve import (
        OracleServeEngine,
        PackedServeEngine,
        build_serve_engine,
        load_serving_model,
        serve_layout_from_cfg,
    )

    check(os.path.isdir(I_CKPT), f"[J4] phase G's checkpoint is not under {I_CKPT}")
    cfg = ckpt_cfg(cfg)
    images = make_mix(np.random.default_rng(9), MIXED_RAGGED, 32, 16)
    t0 = time.perf_counter()
    eng = build_serve_engine(cfg, ckpt_dir=I_CKPT, device="cuda", warn=False)
    got = serve_requests(eng, images)
    build_s = time.perf_counter() - t0
    del eng
    model = load_serving_model(cfg, ckpt_dir=I_CKPT, device="cuda")
    want = serve_requests(PackedServeEngine(model, serve_layout_from_cfg(cfg), warn=False),
                          images)
    same = all(np.array_equal(got[i].cls_feature, w.cls_feature)
               and np.array_equal(got[i].pooled_patch_feature, w.pooled_patch_feature)
               for i, w in want.items())
    print(f"[J4] build_serve_engine(ckpt_dir=step 4) and 32 requests in {build_s:.1f} s: "
          f"bitwise the engine over load_serving_model(ckpt_dir): {same}")
    check(sorted(got) == sorted(want) == list(range(32)) and same,
          "[J4] ckpt_dir build differs")
    ocfg = copy.deepcopy(cfg)
    apply_dot_overrides(ocfg, ["serve.continuous_packing=false", "serve.oracle=per_image"])
    oracle = build_serve_engine(ocfg, model.state_dict(), device="cuda", warn=False)
    check(isinstance(oracle, OracleServeEngine) and oracle.mode == "per_image",
          "[J4] continuous_packing=false did not build the per_image oracle")
    served = serve_requests(oracle, images[:4])
    worst = close_features("J4 per_image oracle vs packed", {i: want[i] for i in served},
                           served)
    print(f"[J4] serve.continuous_packing=false -> {oracle.arm}; 4 requests within "
          f"{worst:.3f} of the packed tolerance")
    del model, oracle
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(J_DIR, "serve_bench.json")
    cmd = [sys.executable, "-m", "dinov3_tpu_torch.serve.bench", "--smoke",
           "--out", out, "--obs-dir", J_DIR]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        tail = (proc.stdout + proc.stderr).splitlines()[-40:]
        raise SmokeFailure(f"[J4] bench --smoke: exit {proc.returncode}\n" + "\n".join(tail))
    with open(out) as f:
        rec = json.load(f)
    mix = rec["mixes"]["mixed_ragged"]
    print(f"[J4] python -m dinov3_tpu_torch.serve.bench --smoke on the card: {wall:.1f} s; "
          f"{rec['arch']} backend {rec['backend']}; mixed_ragged packed "
          f"{mix['packed']['throughput']['images_per_s']} img/s, x"
          f"{mix['speedup_vs_rectangular']} rectangular, x{mix['speedup_vs_per_image']} "
          f"per-image; features vs per-image {mix['features_vs_oracle_per_image']}")
    check(rec["backend"] == "cuda" and rec["packed_compile_count"] == 1
          and set(rec["mixes"]) == {"uniform_224", "mixed_ragged", "heavy_tail"},
          f"[J4] bench record {sorted(rec)}")


def phase_j5() -> dict:
    """K1 with no segment ids at the oracle's dense shapes: 96 px (N 37),
    96 x 512 px (N 193), and 512 px (N 1025) at a batch of 2."""
    import torch

    g = torch.Generator().manual_seed(11)
    rows = {}
    for B, N in ((1, 37), (1, 193), (2, 1025)):
        qkv = torch.randn(B, N, 3 * 1024, generator=g).to("cuda", torch.bfloat16)
        q, k, v = (qkv[..., i * 1024:(i + 1) * 1024].reshape(B, N, 16, 64) for i in range(3))
        rows[f"N={N}"] = check_flash(q.contiguous(), k.contiguous(), v, None,
                                     f"oracle [{B}x16, {N}, 64] bf16 no seg", time_it=True)
    return rows


# ---------------------------------------------------------------- phase K

K_DIR = os.path.join(REPO, "build", "phase_k")
VITG_CONFIG = os.path.join("configs", "train", "vitg14_webshards.yaml")
# the recipe's images a step on one card (train.batch_size_per_device)
VITG_B = 16
# ViT-g/14 (configs/train/vitg14_webshards.yaml): 40 blocks, 1536 wide, 24
# heads of 64, patch 14, 4 registers; 224 px globals (1 + 4 + 256 = 261
# tokens) and 98 px locals (1 + 4 + 49 = 54 tokens), packed 4 to a row
VITG_N, VITG_N_LOCAL, VITG_H, VITG_D = 261, 54, 24, 1536
# K1's CLI run at full width cut to 20 of the recipe's 40 blocks (a 10.3 GB
# save, not 20.5): with phase N the whole smoke passed its 1,200 s on a slow
# host at 40 (PERF.md §5); K0's kernels at ViT-g's shapes and K2's options
# do not depend on the depth
VITG_CLI_DEPTH = 20


def vitg_launches(depth: int) -> dict:
    """K1-K5 launches of one step of the recipe at ``depth`` blocks under
    its ``blocks`` remat: K1 once a teacher, a student and a recomputed
    block; K4 twice a block in each of those, plus the teacher's final norm
    and the student's final and local-CLS norms; K5 once a student K4
    launch; K2, K3 once a student block (120, 40, 40, 243, 82 at 40)."""
    return {"K1": 3 * depth, "K2": depth, "K3": depth, "K4": 6 * depth + 3,
            "K5": 2 * depth + 2}


VITG_LAUNCHES = vitg_launches(VITG_CLI_DEPTH)
# the CLI run of K1: iterations 3-5 profiled (phase L1), the last 4 timed
# (--benchmark, after the profiler's window)
VITG_ITERS, VITG_PROFILE = 11, (3, 5)
# the one-card overrides of the recipe: no FSDP mesh (the port trains on
# one card; parallel.fsdp > 1 is refused, ROADMAP M7)
VITG_OVERRIDES = ["parallel.fsdp=1"]
# the 2-block checks at ViT-g width (K2, as phase F): 4 images, 4096
# prototypes, LayerScale 1
VITG_SMALL = ["train.batch_size_per_device=4", "student.layerscale=1.0",
              "dino.head_n_prototypes=4096", "ibot.head_n_prototypes=4096"]
# the ViT-7B recipes' rescale, with a shift and a jitter on top
ROPE_AUG = ["student.pos_embed_rope_shift_coords=0.05",
            "student.pos_embed_rope_jitter_coords=1.1",
            "student.pos_embed_rope_rescale_coords=2"]


def vitg_attention_seg(batch_size: int = VITG_B, rate: float = 0.4):
    """The seg plane one ViT-g student block's attention sees: the packed
    layout's ids (2B global rows of 261 tokens, 4 local crops of 54 a
    packed row) at the kept rows of a drop-path subset of the port's plan."""
    from dinov3_tpu_torch.ops.packing import make_packed_layout, packed_segment_ids
    from dinov3_tpu_torch.rng import packed_pass_plan, step_generator

    layout = make_packed_layout(n_global_rows=2 * batch_size, n_local=8 * batch_size,
                                seq_global=VITG_N, seq_local=VITG_N_LOCAL, n_prefix=5)
    plan = packed_pass_plan(step_generator(0, 0), 40, layout.rows_total, rate)
    return packed_segment_ids(layout)[plan["drop_path"]["idx"][0, 0].numpy()], layout


def phase_k() -> dict:
    """The ViT-g/14 web-shard recipe on one card (module docstring)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(K_DIR, ignore_errors=True)
    os.makedirs(K_DIR)
    try:
        t0 = time.perf_counter()
        rows = phase_k0()
        print(f"[K] K0 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        cli = phase_k1()
        print(f"[K] K1 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_k2()
        print(f"[K] K2 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_k3()
        print(f"[K] K3 {time.perf_counter() - t0:.1f} s")
        return {"rows": rows, "cli": cli}
    finally:
        shutil.rmtree(K_DIR, ignore_errors=True)


def phase_k0() -> dict:
    """K1-K5 against their plain versions at the recipe's shapes: the
    teacher's [2B x 24, 261, 64] with no ids, one student block's packed
    rows with ids (K1, K2, K3), the two-pass student's locals [n_l B x 24,
    54, 64], and the LayerNorms at D = 1536 (K4 a block's rows and the
    teacher's, K5 a block's and all packed rows)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(11)
    bf16 = torch.bfloat16
    H, D = VITG_H, 64

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    def qkv_views(rows, n):
        qkv = randn(rows, n, 3 * H * D)
        q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(rows, n, H, D)
                   for i in range(3))
        return q.contiguous(), k.contiguous(), v

    seg_np, layout = vitg_attention_seg()
    seg = torch.from_numpy(seg_np).to(dev)
    out = {k: {} for k in ("K1", "K2", "K3", "K4", "K5")}
    R = seg.shape[0]
    q, k, v = qkv_views(R, VITG_N)
    out["K1"]["student"] = check_flash(q, k, v, seg, f"ViT-g student block [{R}x{H}, "
                                       f"{VITG_N}, {D}] bf16 seg", time_it=True)
    bwd = check_flash_bwd(q, k, v, seg, f"ViT-g student block [{R}x{H}, {VITG_N}, {D}] "
                          "bf16 seg", time_it=True)
    out["K2"]["student"], out["K3"]["student"] = bwd["K2"], bwd["K3"]
    del q, k, v
    q, k, v = qkv_views(2 * VITG_B, VITG_N)
    out["K1"]["teacher"] = check_flash(q, k, v, None, f"ViT-g teacher [{2 * VITG_B}x{H}, "
                                       f"{VITG_N}, {D}] bf16 no seg", time_it=True)
    del q, k, v
    n_loc = 8 * VITG_B
    q, k, v = qkv_views(n_loc, VITG_N_LOCAL)
    out["K1"]["two-pass locals"] = check_flash(
        q, k, v, None, f"ViT-g two-pass locals [{n_loc}x{H}, {VITG_N_LOCAL}, {D}] bf16",
        time_it=True)
    bwd = check_flash_bwd(q, k, v, None, f"ViT-g two-pass locals [{n_loc}x{H}, "
                          f"{VITG_N_LOCAL}, {D}] bf16", time_it=True)
    out["K2"]["two-pass locals"], out["K3"]["two-pass locals"] = bwd["K2"], bwd["K3"]
    del q, k, v
    from dinov3_tpu_torch.ops.fused_norm import layernorm_vec_path

    vec = layernorm_vec_path(VITG_D, bf16, (0, 0, 0, 0))
    print(f"[K] K4/K5 at D = {VITG_D} in bf16: vector path with {vec} vectors a lane")
    check(vec == 8, f"[K] D = {VITG_D}: vector path {vec}, not 8 vectors a lane")
    s, b = (torch.randn(VITG_D, generator=g) * 0.5 + 1).to(dev), torch.randn(
        VITG_D, generator=g).to(dev)
    out["K4"]["student block"] = check_layernorm(
        randn(R * VITG_N, VITG_D) * 3 + 1, s, b,
        f"ViT-g student block [{R * VITG_N}, {VITG_D}] bf16, fp32 params", time_it=True)
    out["K4"]["teacher"] = check_layernorm(
        randn(2 * VITG_B * VITG_N, VITG_D) * 3 + 1, s, b,
        f"ViT-g teacher [{2 * VITG_B * VITG_N}, {VITG_D}] bf16, fp32 params", time_it=True)
    out["K5"]["student block"] = check_layernorm_bwd(
        randn(R * VITG_N, VITG_D) * 3 + 1, s,
        f"ViT-g student block [{R * VITG_N}, {VITG_D}] bf16, fp32 scale", time_it=True)
    p_rows = layout.rows_total * VITG_N
    out["K5"]["packed rows"] = check_layernorm_bwd(
        randn(p_rows, VITG_D) * 3 + 1, s,
        f"ViT-g packed rows [{p_rows}, {VITG_D}] bf16, fp32 scale", time_it=True)
    check_layernorm(randn(77, VITG_D, dtype=torch.float32), s, b,
                    f"[77, {VITG_D}] fp32")
    check_layernorm_bwd(randn(77, VITG_D, dtype=torch.float32), s,
                        f"[77, {VITG_D}] fp32")
    return out


def write_web_shards(root: str, n_images: int = 320, per_shard: int = 64,
                     px: int = 256, n_classes: int = 10, seed: int = 0) -> int:
    """``shard-%06d.tar`` files of ``<key>.jpg`` / ``<key>.cls`` pairs: seeded
    smooth images (random 8 x 8 colour fields upsampled bicubically, with
    pixel noise), labels cycling over ``n_classes``. Returns the bytes."""
    import io
    import tarfile

    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    nbytes = 0
    for shard in range(-(-n_images // per_shard)):
        with tarfile.open(os.path.join(root, f"shard-{shard:06d}.tar"), "w") as tf:
            for i in range(shard * per_shard, min(n_images, (shard + 1) * per_shard)):
                label = i % n_classes
                field = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
                img = np.asarray(field.resize((px, px), Image.BICUBIC), np.float32)
                img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=90)
                for name, payload in ((f"{i:08d}.jpg", buf.getvalue()),
                                      (f"{i:08d}.cls", str(label).encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
                    nbytes += len(payload)
    return nbytes


def phase_k1() -> dict:
    """The ViT-g/14 recipe through the trainer CLI at full width, cut to
    ``VITG_CLI_DEPTH`` blocks, from web shards written here: 11 iterations at B=16 (3-5 profiled, the
    step anatomy of phase L1; 7-10 timed, after the profiler's window; one
    save at the end); launches pinned a step, losses finite. The resumes
    in a new process run in phases G and M3."""
    t0 = time.perf_counter()
    shards = os.path.join(K_DIR, "shards")
    nbytes = write_web_shards(shards)
    print(f"[K] K1: 320 JPEGs of 256 px in 5 web shards ({nbytes} bytes) written "
          f"in {time.perf_counter() - t0:.1f} s; disk free "
          f"{shutil.disk_usage(K_DIR).free / 2 ** 30:.1f} GiB")
    base = VITG_OVERRIDES + [f"data.root={shards}", f"checkpointing.period={VITG_ITERS}",
                             f"+student.n_blocks={VITG_CLI_DEPTH}"]
    run = os.path.join(K_DIR, "run")
    losses = os.path.join(K_DIR, "a.jsonl")
    a = run_cli("vitg14 recipe", ["--output-dir", run, "--max-iterations", str(VITG_ITERS),
                                  "--benchmark", "4", "--record-losses", losses,
                                  "--profile-steps", ",".join(map(str, VITG_PROFILE))],
                base=base, label="K", log_dir=K_DIR, config=VITG_CONFIG, timeout=600)
    check(a["launches"] == {k: v * VITG_ITERS for k, v in VITG_LAUNCHES.items()},
          f"[K] launches {a['launches']} != {VITG_ITERS} x {VITG_LAUNCHES}")
    check((a["remat"], a["targets"], a["crop_packing"]) == ("blocks", "streaming", True),
          f"[K] resolved {a['remat']}, {a['targets']}, packing {a['crop_packing']}")
    check([s["step"] for s in a["saves"]] == [VITG_ITERS], f"[K] saves {a['saves']}")
    rec = read_losses(losses)
    check(sorted(rec) == list(range(VITG_ITERS)) and all(
        np.isfinite(v) for r in rec.values() for v in r.values()), f"[K] losses {rec}")
    a["l1"] = phase_l1(run, a)
    print(f"[K] K1 ViT-g/14 at B={VITG_B}, {VITG_CLI_DEPTH} blocks: "
          f"{a['ms_per_step']:.1f} ms a step, "
          f"{a['img_per_sec']:.2f} img/s, peak {a['peak_memory_gib']:.2f} GiB; save "
          f"{a['saves'][0]['bytes']} bytes in {a['saves'][0]['seconds']:.1f} s; losses at "
          f"iteration {VITG_ITERS - 1}: "
          + ", ".join(f"{k} {rec[VITG_ITERS - 1][k]:.4f}" for k in LOSS_KEYS))
    shutil.rmtree(run)
    return a


def phase_k2() -> None:
    """The options the ViT-g slice lifted, in card steps against the CPU
    on a 2-block model at ViT-g width with 2 images (the phase-F pattern):
    the two-pass student with ``rng.plan=false`` and RoPE coordinate
    augmentation; the crop-packed student with RoPE augmentation on the
    second entry of a two-entry crop-size list (a 252 px batch of its
    combined stream; the first entry, 224 px, is the other arm's shape).
    ``--dump-weights`` runs in phase G's resumed run (``check_dump``)."""
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.train.train import build_data_iterator

    vitg = VITG_OVERRIDES + ["data.backend=synthetic", "train.batch_size_per_device=2"]
    card_vs_cpu_step("K2 two-pass, rng.plan=false", vitg + ROPE_AUG + [
        "model.crop_packing=false", "rng.plan=false"], config=VITG_CONFIG)
    lists = ["crops.global_crops_size=[224,252]", "crops.local_crops_size=[98,112]"]
    cfg = load_config(os.path.join(REPO, VITG_CONFIG), vitg + VITG_SMALL + lists
                      + ["train.batch_size_per_device=2"], n_devices=1)
    stream = build_data_iterator(cfg, 2)
    try:
        batches = [next(stream) for _ in range(3)]
    finally:
        stream.close()
    sizes = [b["global_crops"].shape[1] for b in batches]
    check(set(sizes) == {224, 252}, f"[K] crop-size list gave sizes {sizes}")
    # RoPE augmentation with the packed student, on the list's second entry
    card_vs_cpu_step("K2 list, 252 px, rope", vitg + ROPE_AUG + lists, config=VITG_CONFIG,
                     batch=next(b for b in batches if b["global_crops"].shape[1] == 252))


def meta_state_dict(port_sd: dict) -> dict:
    """A port backbone ``state_dict`` in the names of Meta's release:
    SwiGLU's fused ``w12`` split into ``w1`` (gate) and ``w2`` (value), the
    RoPE periods and the qkv bias masks added."""
    import torch

    out = {"rope_embed.periods": torch.zeros(16)}
    for k, v in port_sd.items():
        if ".mlp.w12." in k:
            out[k.replace(".w12.", ".w1.")], out[k.replace(".w12.", ".w2.")] = (
                t.clone() for t in v.chunk(2, dim=0))
        else:
            out[k] = v
        if k.endswith("attn.qkv.bias"):
            mask = torch.ones_like(v)
            mask[v.shape[0] // 3: 2 * v.shape[0] // 3] = 0
            out[k + "_mask"] = mask
    return out


def phase_k3() -> None:
    """A SwiGLU ViT-g state_dict in Meta's names (2 blocks at full width,
    seeded, LayerScale 1) written to a file and served from it by the
    packed engine on the card, against the same engine on the CPU (the
    kernels' plain versions) from the same file."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.models import build_backbone
    from dinov3_tpu_torch.serve import build_serve_engine, serve_layout_from_cfg

    cfg = load_config(os.path.join(REPO, VITG_CONFIG),
                      VITG_OVERRIDES + ["+student.n_blocks=2", "student.layerscale=1.0"],
                      n_devices=1)
    src = build_backbone(cfg, device="cpu", seed=7)
    path = os.path.join(K_DIR, "dinov3_vitg14_2blocks.pth")
    torch.save(meta_state_dict(src.state_dict()), path)
    layout = serve_layout_from_cfg(cfg)
    # the mixed_ragged bands on the 14 px patch grid
    bands = [(p, (-(-lo // 14) * 14, hi // 14 * 14)) for p, (lo, hi) in MIXED_RAGGED]
    images = make_mix(np.random.default_rng(3), bands, 24, layout.patch_size)
    results = {}
    for dev in ("cuda", "cpu"):
        eng = build_serve_engine(cfg, meta_weights=path, device=dev, warn=False)
        for i, im in enumerate(images):
            eng.submit(im, request_id=i)
        reset_counts()
        t0 = time.perf_counter()
        results[dev] = {r.request_id: r for r in eng.flush()}
        counts = read_counts()
        print(f"[K] K3 one pack on {dev}: {len(results[dev])} requests, "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, launches {counts}")
        if dev == "cuda":
            check(counts["K1"] == 2 and counts["K4"] == 6,
                  f"[K] K3 launches {counts}, not K1 2 and K4 6 a pack")
    check(results["cuda"].keys() == results["cpu"].keys() and results["cpu"],
          "[K] K3 card and CPU served other requests")
    scale = max(float(np.abs(r.cls_feature).max()) for r in results["cpu"].values())
    tol = 2.0 ** -4 * max(scale, 1.0)  # as phase D: bf16 on both, other sum orders
    worst = max(float(np.abs(getattr(results["cuda"][i], n) - getattr(c, n)).max())
                for i, c in results["cpu"].items()
                for n in ("cls_feature", "pooled_patch_feature"))
    print(f"[K] K3 Meta-layout ViT-g weights served: card vs CPU worst feature error "
          f"{worst:.3e} (tol {tol:.3e})")
    check(worst <= tol, f"[K] K3 card vs CPU features {worst:.3e} > {tol:.3e}")


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase L

L_DIR = os.path.join(REPO, "build", "phase_l")
# a kernel event of each wrapper call (K1's tile schedule and K5's column
# pass are second kernels of one call, not counted)
KERNEL_EVENTS = {
    "K1": re.compile(r"flash_fwd_(?:wgmma|bf16|f32)\b"),
    "K2": re.compile(r"flash_bwd_dq_(?:wgmma|bf16|f32)\b"),
    "K3": re.compile(r"flash_bwd_dkv_(?:wgmma|bf16|f32)\b"),
    "K4": re.compile(r"layernorm_fwd(?:_vec)?\b"),
    "K5": re.compile(r"layernorm_bwd_(?:vec|rows)\b"),
}


def anatomy_lines(label: str, ledger: dict, trace, pins: dict, top: int = 10) -> dict:
    """Print a ledger's steps (device ms by category, busy, wall, idle
    share, backward, named scopes) and the top kernels by device ms, and
    hold the ledger against the trace it was read from:
    - each step's categories sum, within 1 %, to the union of the step's
      device intervals taken from the trace (an event counted twice, or
      kernels that overlap, break it);
    - the ledger's steps plus its unwindowed time hold all the trace's
      device time within 1 %, and the unwindowed time is under 1 % of it
      (an event the ledger lost, or a launch outside every step);
    - every step's K1-K5 kernel events equal ``pins`` (a step that
      Kineto cut short, or a launch given to the wrong step)."""
    from dinov3_tpu_torch.telemetry import events_by_step
    from dinov3_tpu_torch.telemetry.anatomy import merge_intervals

    by_step = events_by_step(trace)
    total = sum(e.dur for e in trace.op_events()) / 1e3
    busy_sum = sum(st["device_busy_ms"] for st in ledger["steps"])
    check(abs(busy_sum + ledger["unwindowed_ms"] - total) <= 0.01 * total
          and ledger["unwindowed_ms"] <= 0.01 * total,
          f"[{label}] steps {busy_sum} + unwindowed {ledger['unwindowed_ms']} ms "
          f"vs the trace's {total} ms of device time")
    rows = []
    events = {k: 0 for k in KERNEL_EVENTS}
    for st in ledger["steps"]:
        it = st["iteration"]
        busy, wall = st["device_busy_ms"], st["wall_ms"]
        cats = sum(st["device_ms"].values())
        occupied = sum(e - s for s, e in merge_intervals(
            [(ev.ts, ev.end) for ev in by_step.get(it, [])])) / 1e3
        check(abs(cats - occupied) <= 0.01 * occupied,
              f"[{label}] step {it}: categories {cats} vs the union of its device "
              f"intervals {occupied} (busy {busy})")
        got = {k: sum(bool(rx.search(e.name)) for e in by_step.get(it, []))
               for k, rx in KERNEL_EVENTS.items()}
        check(got == pins, f"[{label}] step {it}: K1-K5 events {got} != {pins}")
        for k in events:
            events[k] += got[k]
        rows.append({"busy": busy, "wall": wall, "backward": st["backward_ms"],
                     **st["device_ms"]})
        print(f"[{label}] step {it}: device busy {busy:.2f} ms (union {occupied:.2f}), "
              f"wall {wall:.2f} ms, idle share {max(0.0, 1 - busy / wall):.4f}, backward "
              f"{st['backward_ms']:.2f} ms; " + ", ".join(
                  f"{c} {v:.2f}" for c, v in sorted(st["device_ms"].items(), key=lambda r: -r[1]))
              + "; scopes " + ", ".join(f"{k} {v:.3f}" for k, v in st.get("scopes", {}).items()))
    by_name: dict = {}
    for e in (e for st in ledger["steps"] for e in by_step.get(st["iteration"], [])):
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.dur / 1e3)
    n = max(1, len(rows))
    for name, (cnt, t) in sorted(by_name.items(), key=lambda r: -r[1][1])[:top]:
        print(f"[{label}]   {t / n:8.3f} ms a step  x{cnt / n:<7.1f} {name[:110]}")
    print(f"[{label}] the trace's device time {total:.2f} ms = steps {busy_sum:.2f} + "
          f"unwindowed {ledger['unwindowed_ms']:.3f} ms")
    keys = sorted({k for r in rows for k in r})
    return {"per_step": {k: sum(r.get(k, 0.0) for r in rows) / n for k in keys},
            "kernel_events": events, "n_steps": len(rows)}


def phase_l1(run_dir: str, result: dict) -> dict:
    """The ViT-g/14 recipe's step anatomy from phase K1's CLI run: the
    ledger the trainer wrote (``<run>/trace/anatomy.json``) and its trace,
    per step; K1-K5 kernel events in the window against the pins; the
    host's dispatch and data-wait spans a step from the run's span
    stream."""
    from dinov3_tpu_torch.telemetry import (
        find_trace_file,
        fleet_report,
        load_span_streams,
        load_trace,
    )

    t0 = time.perf_counter()
    with open(os.path.join(run_dir, "trace", "anatomy.json")) as f:
        ledger = json.load(f)
    trace = load_trace(find_trace_file(os.path.join(run_dir, "trace")))
    check([st["iteration"] for st in ledger["steps"]] == list(range(VITG_PROFILE[0],
                                                                   VITG_PROFILE[1] + 1)),
          f"[L1] ledger steps {[st.get('iteration') for st in ledger['steps']]}")
    steps = VITG_PROFILE[1] - VITG_PROFILE[0] + 1
    out = anatomy_lines("L1", ledger, trace, VITG_LAUNCHES)
    want = {k: v * steps for k, v in VITG_LAUNCHES.items()}
    check(out["kernel_events"] == want,
          f"[L1] K1-K5 events in the window {out['kernel_events']} != {want}")
    streams = load_span_streams(run_dir)["rank0"]
    host = {name: [r["dur_ms"] for r in streams if r.get("name") == name
                   and (r.get("iteration") or 0) > 0]
            for name in ("dispatch", "data_wait", "h2d")}
    out["host_ms"] = {k: float(np.median(v)) for k, v in host.items() if v}
    print(f"[L1] the host a step (median of iterations 1-{VITG_ITERS - 1}, spans): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in out["host_ms"].items())
          + f"; fleet verdict {fleet_report({'rank0': streams})['verdict']}")
    print(f"[L1] the window's {steps} steps: K1-K5 events "
          f"{out['kernel_events']} (= {steps} x the pins); the trainer's summary ({steps} steps) "
          f"{result.get('anatomy', {}).get('device_ms_per_step')}; "
          f"unwindowed {ledger['unwindowed_ms']:.2f} ms; read in {time.perf_counter() - t0:.1f} s")
    return out


def profiled_window(label: str, setup, state, dbatch, pins: dict, steps: int = 2) -> dict:
    """``steps`` steps of ``setup.step_fn`` under the trainer's profiler
    window (``SpanTracer``: ``train_step#N`` annotations, after one step
    under its warm-up), read by the step-anatomy ledger and held against
    the trace (``anatomy_lines``)."""
    from dinov3_tpu_torch.telemetry import (
        SpanTracer,
        anatomy_ledger,
        find_trace_file,
        load_trace,
    )

    tdir = os.path.join(L_DIR, f"trace_{label.replace(' ', '_')}")
    shutil.rmtree(tdir, ignore_errors=True)
    first = state.step
    # the first iteration runs under the profiler's warm-up (SpanTracer)
    tracer = SpanTracer(None, profile_steps=(first + 1, first + steps), profile_dir=tdir)
    for _ in range(steps + 1):
        it = state.step
        tracer.profile_step_begin(it)
        with tracer.step_annotation(it):
            state, _ = setup.step_fn(state, dbatch, setup.scalars(it))
        tracer.profile_step_end(it)
    trace = load_trace(find_trace_file(tdir))
    out = anatomy_lines(label, anatomy_ledger(trace), trace, pins)
    shutil.rmtree(tdir, ignore_errors=True)
    return out


def phase_l2() -> dict:
    """The ViT-L/16 recipe as written (B=64, streaming targets, full depth)
    in bf16, fp8 and int8 (``train.low_precision.arm``): 5 timed steps
    each after a warm-up, launches pinned, every loss finite, the drift
    probe against ``divergence_tol``; a profiled window of 2 steps for
    bf16 and fp8."""
    out = {}
    for arm in ("bf16", "fp8", "int8"):
        extra = [] if arm == "bf16" else [f"train.low_precision.arm={arm}"]
        out[arm] = r = recipe_arm(f"L2 {arm}", extra, 5, STEP_LAUNCHES,
                                  window=arm in ("bf16", "fp8"))
        drift = r["drift"]
        print(f"[L2] {arm}: {r['median_ms']:.1f} ms a step, {r['B'] / r['median_ms'] * 1e3:.2f} "
              f"img/s, peak {r['peak_gib']:.2f} GiB"
              + ("" if drift is None else f"; drift probe max {drift['max']:.4g} against "
                 f"divergence_tol {r['divergence_tol']:.4g}"))
        if drift is not None:
            check(drift["max"] <= r["divergence_tol"], f"[L2] {arm} drift {drift}")
    for arm in ("fp8", "int8"):
        print(f"[L2] {arm} / bf16: step {out[arm]['median_ms'] / out['bf16']['median_ms']:.4f} x, "
              f"peak {out[arm]['peak_gib'] - out['bf16']['peak_gib']:+.2f} GiB")
    wb, wf = out["bf16"]["window"]["per_step"], out["fp8"]["window"]["per_step"]
    for cat in ("matmul/conv", "fusion/elementwise", "norm/reduce", "softmax/exp",
                "copy/layout", "busy", "wall"):
        print(f"[L2] {cat:>18}: bf16 {wb.get(cat, 0.0):8.2f} ms, fp8 {wf.get(cat, 0.0):8.2f} ms a step")
    return out


@contextlib.contextmanager
def planted_backward(kind: str):
    """A deliberately wrong straight-through backward of ``lowp_matmul``,
    in this process, while the context is open: ``wide_x`` takes dw from
    the wide activation instead of its codes, ``wide_w`` takes dx from
    the wide weight instead of its codes. Phase L3's negative controls:
    the gradient check must fail on each."""
    from dinov3_tpu_torch.ops import lowp

    cls = lowp._LowpMatmul
    fwd, bwd = cls.forward, cls.backward

    def forward(ctx, x, w, scale, arm):
        out = fwd(ctx, x, w, scale, arm)
        ctx.wide = (x.detach(), w.detach())
        return out

    def backward(ctx, g):
        dx, dw, _, _ = bwd(ctx, g)
        x, w = ctx.wide
        if kind == "wide_x":
            dw = (g.reshape(-1, g.shape[-1]).t()
                  @ x.reshape(-1, x.shape[-1]).to(g.dtype)).to(dw.dtype)
        else:
            dx = (g @ w.to(g.dtype)).to(dx.dtype)
        return dx, dw, None, None

    cls.forward, cls.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield
    finally:
        cls.forward, cls.backward = staticmethod(fwd), staticmethod(bwd)


@contextlib.contextmanager
def ste_reference():
    """``lowp_matmul``'s backward replaced, while the context is open, by
    its rule written as plain autograd, independent of the port's
    hand-written backward: the value is the port's own forward (held
    against the plain version at the op level), the gradient comes from
    the straight-through identity ``v + (v_hat - v).detach()`` on both
    operands in float64, each code dequantized in the compute dtype as
    the rule has it (dx from the weight's codes, dw from the
    activation's). The forward being the port's, both runs see the same
    activations and codes; only the backward differs."""
    import torch

    from dinov3_tpu_torch.ops import lowp

    port = lowp.lowp_matmul

    def ste_matmul(arm, x, w, scale):
        spec = lowp.qspec(arm)
        s_w = scale.detach().float()
        s_x = lowp.current_scale(x.detach(), spec.qmax)
        x_hat = (lowp.quantize(x.detach(), s_x, spec).float() * s_x).to(x.dtype)
        w_hat = (lowp.quantize(w.detach(), s_w, spec).float() * s_w).to(w.dtype)
        xs = x.double() + (x_hat.double() - x.double()).detach()
        ws = w.double() + (w_hat.double() - w.double()).detach()
        prod = xs @ ws.t()
        with torch.no_grad():
            value = port(arm, x, w, scale)
        return value + (prod - prod.detach()).to(value.dtype)

    lowp.lowp_matmul = ste_matmul
    try:
        yield
    finally:
        lowp.lowp_matmul = port


# phase L3's gradient check: the student's castable-weight gradients of one
# 2-block recipe forward at an arm on the card, the port against
# ``ste_reference``, relative L2 error of the worst leaf. The port rounds
# its two backward products to bf16 (2^-9 relative an entry) where the
# reference keeps float64, on the same activations and codes: a sound arm
# lies within 2^-7; each planted
# backward moves a product by the quantization error of an operand (the
# arm's quantum, 2^-4 relative for fp8, 1/254 of the range for int8) and
# must lie outside
LOWP_GRAD_TOL = 2.0 ** -7


def lowp_grads_on_card(arm: str) -> dict:
    """The student's gradients of one forward and backward at ``arm`` on a
    2-block model at the ViT-L/16 recipe's width (the phase-F pattern:
    same weights, batch, plan and scales), per castable weight (``qkv``,
    ``proj``, ``fc1``, ``fc2``). Held: the port on the card against
    ``ste_reference`` on the card within ``LOWP_GRAD_TOL``, and each
    planted backward (``planted_backward``) outside it. Printed, not held:
    the arm and the same model in bf16, card against CPU (quantization
    turns the two devices' bf16 rounding into flipped codes)."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.configs.config import lowp_cfg
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.ops.lowp import lowp_bound, lowp_scales
    from dinov3_tpu_torch.rng import plan_to_device
    from dinov3_tpu_torch.train import build_train_setup, put_batch

    B = 4
    cfg = load_config(
        os.path.join(REPO, CLI_CONFIG),
        [f"train.batch_size_per_device={B}", "student.layerscale=1.0",
         "dino.head_n_prototypes=4096", "ibot.head_n_prototypes=4096",
         f"train.low_precision.arm={arm}"], n_devices=1)
    lp = lowp_cfg(cfg)
    batch = make_synthetic_batch(cfg, B, seed=1)
    it = cfg.optim.warmup_epochs * cfg.train.OFFICIAL_EPOCH_LENGTH
    plan, grads, seconds = None, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        setup = build_train_setup(cfg, batch, device=dev, seed=2, n_blocks=2)
        seconds[f"{dev} setup"] = time.perf_counter() - t0
        meta, state = setup.meta, setup.state
        if plan is None:
            plan = meta.draw_plan(0, it, batch)
        scales = {k: lowp_scales(h, arm, lp["scale_margin"]) for k, h in state.lowp.items()}
        dbatch, dplan = put_batch(batch, dev), plan_to_device(plan, dev)
        temp = float(setup.scalars(it)["teacher_temp"])
        runs = [("arm", True, None), ("bf16", False, None)]
        if dev == "cuda":
            runs += [("ste", True, ste_reference), ("wide_x", True, "wide_x"),
                     ("wide_w", True, "wide_w")]
        for name, bound, swap in runs:
            t0 = time.perf_counter()
            meta.student.zero_grad(set_to_none=True)
            with contextlib.ExitStack() as stack:
                if bound:
                    for k in ("student", "teacher"):
                        stack.enter_context(lowp_bound(getattr(meta, k)["backbone"],
                                                       scales[k], arm))
                if isinstance(swap, str):
                    stack.enter_context(planted_backward(swap))
                elif swap is not None:
                    stack.enter_context(swap())
                total, _, _ = meta(dbatch, teacher_temp=temp, iteration=it, plan=dplan,
                                   state=state.center_state)
                total.backward()
            grads[dev, name] = {
                n: meta.student.get_parameter(f"backbone.{n}").grad.detach().float().cpu()
                for n in scales["student"]}
            seconds[f"{dev} {name}"] = time.perf_counter() - t0
        meta.student.zero_grad(set_to_none=True)
        del setup, meta, state, scales
        gc.collect()
        torch.cuda.empty_cache()

    def worst(a: tuple, b: tuple) -> tuple:
        rel = {n: ((grads[a][n] - g).norm() / g.norm()).item() for n, g in grads[b].items()}
        n = max(rel, key=rel.get)
        return rel[n], n

    ref = ("cuda", "ste")
    out = {"arm": worst(("cuda", "arm"), ref),
           "wide_x": worst(("cuda", "wide_x"), ref),
           "wide_w": worst(("cuda", "wide_w"), ref),
           "card_vs_cpu": worst(("cuda", "arm"), ("cpu", "arm")),
           "card_vs_cpu_bf16": worst(("cuda", "bf16"), ("cpu", "bf16"))}
    print(f"[L3 {arm}] student gradients on the card against the float64 straight-through "
          f"reference, worst castable leaf's relative L2 error: {arm} {out['arm'][0]:.3e} "
          f"({out['arm'][1]}); planted dw from the wide x {out['wide_x'][0]:.3e}, dx from "
          f"the wide w {out['wide_w'][0]:.3e} (tol {LOWP_GRAD_TOL:.3e}); card vs CPU, not "
          f"held: {arm} {out['card_vs_cpu'][0]:.3e}, bf16 {out['card_vs_cpu_bf16'][0]:.3e}; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    check(out["arm"][0] <= LOWP_GRAD_TOL, f"[L3 {arm}] gradients {out['arm']}")
    for name in ("wide_x", "wide_w"):
        check(out[name][0] > LOWP_GRAD_TOL,
              f"[L3 {arm}] the planted {name} backward passes the gradient check: {out[name]}")
    return {k: v[0] for k, v in out.items()}


def phase_l3() -> dict:
    """``lowp_matmul`` on the card against its plain version at the
    recipe's ``qkv`` and ``fc2`` shapes (the packed student's rows at B=64),
    the student's gradients of a 2-block fp8 and int8 recipe forward on
    the card against a float64 straight-through reference, with two
    planted wrong backwards as negative controls, and
    a 2-block fp8 and int8 recipe step, card against CPU."""
    import torch

    from dinov3_tpu_torch.ops.lowp import (
        codes_matmul,
        codes_matmul_plain,
        current_scale,
        lowp_matmul,
        qspec,
        quantize,
    )

    rows = recipe_packed_rows() * 197
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, k, n in (("qkv", 1024, 3072), ("fc2", 4096, 1024)):
        x = torch.randn(rows, k, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).bfloat16()
        for arm in ("int8", "fp8"):
            spec = qspec(arm)
            s_w = w.float().abs().amax() / spec.qmax
            q_x, q_w = quantize(x, current_scale(x, spec.qmax), spec), quantize(w, s_w, spec)
            card = codes_matmul(q_x, q_w, arm)
            plain = codes_matmul_plain(q_x, q_w, arm)
            ms = cuda_ms(lambda: codes_matmul(q_x, q_w, arm), 10)
            plain_ms = cuda_ms(lambda: codes_matmul_plain(q_x, q_w, arm), 3)
            lib_ms = cuda_ms(lambda: x @ w.t(), 10)
            if arm == "int8":
                check(torch.equal(card, plain), f"[L3] int8 {name}: card != plain")
                err = 0.0
            else:
                # Hopper's fp8 MMA keeps ~22 bits between its promotions to
                # fp32: each output within 2^-10 of its absolute product sum
                # (K <= 2^12 terms, 2^-22 each)
                absum = codes_matmul_plain(q_x.float().abs().to(spec.qdtype),
                                           q_w.float().abs().to(spec.qdtype), arm)
                err = ((card - plain).abs() / absum.clamp_min(1e-30)).max().item()
                check(err <= 2.0 ** -10, f"[L3] fp8 {name}: {err:.3e} of the absolute sum")
            print(f"[L3] {arm} {name} [{rows}, {k}] x [{k}, {n}]: card {ms:.4f} ms "
                  f"(plain {plain_ms:.4f}, bf16 x @ w.T {lib_ms:.4f}); "
                  + ("bitwise the plain version" if arm == "int8"
                     else f"within {err:.3e} of the absolute product sum (tol {2.0 ** -10:.3e})"))
            # gradients: the straight-through backward against fp32 products
            # of the same dequantized codes, within the bf16 bound
            sub = slice(0, 4096)
            xs = x[sub].clone().requires_grad_()
            ws = w.clone().requires_grad_()
            g = torch.randn(4096, n, device="cuda", generator=gen).bfloat16()
            lowp_matmul(arm, xs, ws, s_w).backward(g)
            s_x = current_scale(x[sub], spec.qmax)
            x_hat = quantize(x[sub], s_x, spec).float() * s_x
            w_hat = q_w.float() * s_w
            for what, got, want in (("dx", xs.grad, g.float() @ w_hat.bfloat16().float()),
                                    ("dw", ws.grad, g.float().t() @ x_hat.bfloat16().float())):
                rel = ((got.float() - want).abs().max() / want.abs().max()).item()
                check(rel <= 2.0 ** -7, f"[L3] {arm} {name} {what}: {rel:.3e}")
            print(f"[L3] {arm} {name}: dx, dw within 2^-7 of the fp32 products of the codes")
            del card, plain
    # the backward: the student's gradients on the card against the
    # straight-through reference, and under planted wrong backwards, which
    # must fail (LOWP_GRAD_TOL)
    grads = {arm: lowp_grads_on_card(arm) for arm in ("fp8", "int8")}
    # the updated students: an activation whose card and CPU values (bf16,
    # summed in other orders) straddle a quantization boundary takes codes
    # one quantum apart, and its straight-through contribution to dW moves
    # by that quantum (up to 1/8 of it for fp8's 3 mantissa bits): more of
    # the small-gradient entries that Adam's sign-like first step amplifies
    # land apart than in bf16, so 0.8 of the moved entries within a tenth
    # of their step, where the bf16 steps hold 0.9. The share follows the
    # gradients' signs only, not their size: the gradient check above is
    # the one that holds the backward, and the planted step shows what the
    # share reads of a wrong one
    for arm in ("fp8", "int8"):
        card_vs_cpu_step(f"L3 {arm}", [f"train.low_precision.arm={arm}"], moved_close=0.8,
                         planted="wide_x")
    return {"grads": grads}


def phase_l4() -> dict:
    """The trainer CLI at ``CLI_DEPTH`` blocks with the telemetry flags: 8
    iterations with ``telemetry.flush_every=4`` under ``--debug-nans`` and
    ``--tensorboard`` (every loss recorded, 2 blocking fetches for the
    metrics, no NaN); then in this process a NaN planted in a block's GELU
    output, which ``--debug-nans`` names."""
    import torch

    import dinov3_tpu_torch.train.train as T
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.ops import ffn

    run = os.path.join(L_DIR, "cli")
    losses = os.path.join(L_DIR, "l4.jsonl")
    r = run_cli("telemetry flags", ["--output-dir", run, "--max-iterations", "8",
                                    "--debug-nans", "--tensorboard", "--record-losses", losses],
                overrides=["telemetry.flush_every=4", "checkpointing.period=8"],
                label="L4", log_dir=L_DIR)
    check(r["launches"] == {k: 8 * v for k, v in CLI_STEP_LAUNCHES.items()},
          f"[L4] launches {r['launches']}")
    rec = read_losses(losses)
    check(sorted(rec) == list(range(8)) and all(np.isfinite(v["total_loss"])
                                                for v in rec.values()), f"[L4] losses {rec}")
    check(r["host_sync"]["fetches"] == 2 and r["metrics"] == "ring",
          f"[L4] metrics fetches {r['host_sync']} ({r['metrics']})")
    with open(os.path.join(L_DIR, "telemetry flags.log")) as f:
        log = f.read()
    tb_warn = "neither tensorboardX nor torch.utils.tensorboard" in log
    tb_dir = os.path.isdir(os.path.join(run, "tb"))
    check(tb_warn or tb_dir, "[L4] --tensorboard: neither a warning nor events")
    print(f"[L4] 8 iterations, flush_every 4, --debug-nans, --tensorboard: every loss "
          f"recorded, {r['host_sync']['fetches']} metrics fetches "
          f"({r['host_sync']['blocked_ms']} ms blocked); tensorboard "
          + ("warned: no writer on this machine" if tb_warn else "events written"))
    cfg = load_config(os.path.join(REPO, CLI_CONFIG), CLI_OVERRIDES, n_devices=1)
    cfg.train.output_dir = os.path.join(L_DIR, "planted")
    args = T.get_args_parser().parse_args(["--max-iterations", "1", "--debug-nans"])
    gelu = ffn.exact_gelu
    ffn.exact_gelu = lambda x: gelu(x).mul(float("nan"))
    try:
        T.do_train(cfg, args)
        raise SmokeFailure("[L4] a planted NaN did not raise under --debug-nans")
    except FloatingPointError as e:
        check("aten.mul.Tensor produced a NaN in the forward" in str(e), f"[L4] {e}")
        print(f"[L4] planted NaN: {e}")
    finally:
        ffn.exact_gelu = gelu
        gc.collect()
        torch.cuda.empty_cache()
    return r


def phase_l() -> dict:
    """L2-L4 (L1 runs inside phase K's CLI run, module docstring)."""
    shutil.rmtree(L_DIR, ignore_errors=True)
    os.makedirs(L_DIR)
    try:
        out = {}
        for name, fn in (("L2", phase_l2), ("L3", phase_l3), ("L4", phase_l4)):
            t0 = time.perf_counter()
            out[name] = fn()
            print(f"[L] {name} {time.perf_counter() - t0:.1f} s")
        return out
    finally:
        shutil.rmtree(L_DIR, ignore_errors=True)


# ---------------------------------------------------------------- phase M

M_DIR = os.path.join(REPO, "build", "phase_m")
GRAM_CONFIG = os.path.join("configs", "train", "vit7b16_gram_anchor.yaml")
# the recipe's images a step on one card (train.batch_size_per_device)
GRAM_B = 16
# ViT-7B/16 (configs/train/vit7b16_gram_anchor.yaml): 4096 wide, 32 heads
# of 128, patch 16, 4 registers; 256 px globals (1 + 4 + 256 = 261
# tokens), 112 px locals (1 + 4 + 49 = 54) packed 4 to a row, 512 px Gram
# teacher crops (1 + 4 + 1024 = 1029), their 32 x 32 grid resized onto 16 x 16
GRAM_N, GRAM_N_LOCAL, GRAM_N_TEACHER, GRAM_H, GRAM_D = 261, 54, 1029, 32, 4096
# the one-card overrides of the recipe: no FSDP mesh (ROADMAP M7), synthetic data
GRAM_OVERRIDES = ["parallel.fsdp=1", "data.backend=synthetic"]
# the step's depth at full width: the fp32 student, its gradient, Adam's
# moments, the EMA teacher and the Gram copy take 24 B a parameter, ~4 GB a
# 168 M-parameter block, so the 40 blocks do not fit one 80 GB card; this
# is the deepest cut whose step stays under ~70 GB (PERF.md §4)
GRAM_DEPTH = 11
# the CLI runs of M3: one refresh, after iteration 2 (between the step-2
# save, which then holds the Gram branch loaded from gram.ckpt, and the
# step-4 save); at GRAM_CLI_DEPTH block with small heads (4096 prototypes,
# hidden width 2048): a save (student, teacher, moments, Gram branch) is
# 3.9 GB. At 4 blocks it is 14.0 GB, and M3's four (the anchor's, 2 and 4
# of the uninterrupted run, 4 of the resumed one) take 53 GB of the
# card's machine's disk, past the 45 GiB that a run there may write
# (PERF.md §7); phase G holds the resume at 4 blocks of ViT-L
GRAM_CADENCE = ["gram.it_first_update=3", "gram.update_frequency=3", "gram.max_updates=1"]
GRAM_CLI_DEPTH = 1
GRAM_CLI_SMALL = ["dino.head_n_prototypes=4096", "ibot.head_n_prototypes=4096",
                  "dino.head_hidden_dim=2048", "ibot.head_hidden_dim=2048"]


def gram_launches(depth: int) -> dict:
    """K1-K5 launches of one step of the recipe at ``depth`` blocks under
    its ``blocks`` remat: K1 once a block in the teacher, the Gram teacher,
    the student and its recompute; K4 twice a block in each of those, plus
    the prefix and patch norms of the teacher and the Gram teacher (untied
    CLS norms) and the student's three final norms; K2, K3 once a student
    block; K5 once a student K4 launch."""
    return {"K1": 4 * depth, "K2": depth, "K3": depth, "K4": 8 * depth + 7,
            "K5": 2 * depth + 3}


def gram_attention_seg(depth: int = GRAM_DEPTH, rate: float = 0.4):
    """The seg plane one ViT-7B student block's attention sees (the packed
    layout's ids of 2B global rows of 261 tokens and 4 local crops of 54 a
    packed row, at the kept rows of a drop-path subset of the port's plan)
    and the layout."""
    from dinov3_tpu_torch.ops.packing import make_packed_layout, packed_segment_ids
    from dinov3_tpu_torch.rng import packed_pass_plan, step_generator

    layout = make_packed_layout(n_global_rows=2 * GRAM_B, n_local=8 * GRAM_B,
                                seq_global=GRAM_N, seq_local=GRAM_N_LOCAL, n_prefix=5)
    plan = packed_pass_plan(step_generator(0, 0), depth, layout.rows_total, rate)
    return packed_segment_ids(layout)[plan["drop_path"]["idx"][0, 0].numpy()], layout


def phase_m() -> dict:
    """The Gram anchor at ViT-7B width on one card (module docstring)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(M_DIR, ignore_errors=True)
    os.makedirs(M_DIR)
    m2 = None
    try:
        out = {}
        for name, fn in (("M0", phase_m0), ("M1", phase_m1)):
            t0 = time.perf_counter()
            out[name] = fn()
            print(f"[M] {name} {time.perf_counter() - t0:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
        # M2's CPU half takes ~50 s of the host's cores and M3's children
        # wait mostly on the disk: M2 runs in a process of its own beside M3
        t0 = time.perf_counter()
        m2 = subprocess.Popen([sys.executable, os.path.abspath(__file__), M2_CHILD],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        out["M3"] = phase_m3()
        print(f"[M] M3 {time.perf_counter() - t0:.1f} s")
        m2_out, _ = m2.communicate(timeout=600)
        print(m2_out.rstrip())
        check(m2.returncode == 0, f"[M] M2 exit {m2.returncode}")
        print(f"[M] M2 and M3 {time.perf_counter() - t0:.1f} s")
        return out
    finally:
        if m2 is not None and m2.poll() is None:
            m2.kill()
            m2.wait()
        shutil.rmtree(M_DIR, ignore_errors=True)


def phase_m0() -> dict:
    """K1-K5 against their plain versions at the recipe's head_dim-128 and
    D = 4096 shapes: one student block's packed rows with ids (K1, K2,
    K3), the teacher's [2B x 32, 261, 128] and the Gram teacher's [2B x
    32, 1029, 128] with no ids (K1); the LayerNorms' general path at D =
    4096 (K4 on a student block's rows, the teacher's and the Gram
    teacher's; K5 on a block's rows and all packed rows)."""
    import torch

    from dinov3_tpu_torch.ops.fused_norm import layernorm_vec_path

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(13)
    bf16 = torch.bfloat16
    H, D = GRAM_H, GRAM_D // GRAM_H

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    def qkv_views(rows, n):
        qkv = randn(rows, n, 3 * H * D)
        q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(rows, n, H, D)
                   for i in range(3))
        return q.contiguous(), k.contiguous(), v

    seg_np, layout = gram_attention_seg()
    seg = torch.from_numpy(seg_np).to(dev)
    out = {k: {} for k in ("K1", "K2", "K3", "K4", "K5")}
    R = seg.shape[0]
    q, k, v = qkv_views(R, GRAM_N)
    label = f"ViT-7B student block [{R}x{H}, {GRAM_N}, {D}] bf16 seg"
    out["K1"]["student"] = check_flash(q, k, v, seg, label, time_it=True)
    bwd = check_flash_bwd(q, k, v, seg, label, time_it=True)
    out["K2"]["student"], out["K3"]["student"] = bwd["K2"], bwd["K3"]
    del q, k, v
    for name, n in (("teacher", GRAM_N), ("gram teacher", GRAM_N_TEACHER)):
        q, k, v = qkv_views(2 * GRAM_B, n)
        out["K1"][name] = check_flash(q, k, v, None, f"ViT-7B {name} [{2 * GRAM_B}x{H}, "
                                      f"{n}, {D}] bf16 no seg", time_it=True)
        del q, k, v
    vec = layernorm_vec_path(GRAM_D, bf16, (0, 0, 0, 0))
    print(f"[M] K4/K5 at D = {GRAM_D} in bf16: "
          + (f"vector path with {vec} vectors a lane" if vec else "general path"))
    check(vec == 0, f"[M] D = {GRAM_D}: vector path {vec}, not the general path")
    s, b = (torch.randn(GRAM_D, generator=g) * 0.5 + 1).to(dev), torch.randn(
        GRAM_D, generator=g).to(dev)
    for name, rows in (("student block", R * GRAM_N), ("teacher", 2 * GRAM_B * GRAM_N),
                       ("gram teacher", 2 * GRAM_B * GRAM_N_TEACHER)):
        out["K4"][name] = check_layernorm(
            randn(rows, GRAM_D) * 3 + 1, s, b,
            f"ViT-7B {name} [{rows}, {GRAM_D}] bf16, fp32 params", time_it=True)
    p_rows = layout.rows_total * GRAM_N
    for name, rows in (("student block", R * GRAM_N), ("packed rows", p_rows)):
        out["K5"][name] = check_layernorm_bwd(
            randn(rows, GRAM_D) * 3 + 1, s,
            f"ViT-7B {name} [{rows}, {GRAM_D}] bf16, fp32 scale", time_it=True)
    check_layernorm(randn(77, GRAM_D, dtype=torch.float32), s, b, f"[77, {GRAM_D}] fp32")
    check_layernorm_bwd(randn(77, GRAM_D, dtype=torch.float32), s, f"[77, {GRAM_D}] fp32")
    return out


def phase_m1() -> dict:
    """The recipe's step (``vit7b16_gram_anchor.yaml`` with
    ``GRAM_OVERRIDES``: B=16, 2 x 16 Gram teacher crops of 512 px,
    262,144 / 98,304 prototypes, ``blocks`` remat) at full width, cut to
    ``GRAM_DEPTH`` blocks, through ``build_train_setup`` + ``step_fn``: a
    warm-up step, 3 timed steps with every loss finite, the launches
    pinned a step, one step profiled by kernel class, the Gram branch
    untouched by the steps; then one refresh, after which the Gram branch
    is the teacher's backbone."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup, put_batch
    from dinov3_tpu_torch.train.gram_refresh import refresh_gram

    cfg = load_config(os.path.join(REPO, GRAM_CONFIG), GRAM_OVERRIDES, n_devices=1)
    batch = make_synthetic_batch(cfg, GRAM_B, seed=0)
    check(batch["gram_teacher_crops"].shape == (2 * GRAM_B, 512, 512, 3)
          and batch["global_crops"].shape == (2 * GRAM_B, 256, 256, 3),
          f"[M] batch {[(k, v.shape) for k, v in batch.items()]}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = build_train_setup(cfg, batch, device="cuda", seed=0, n_blocks=GRAM_DEPTH)
    setup_s = time.perf_counter() - t0
    meta = setup.meta
    check(meta.gram is not None and meta.student["backbone"].remat == "blocks"
          and meta.student["backbone"].embed_dim == GRAM_D,
          "[M] the step did not resolve a frozen Gram branch under blocks remat at 4096")
    n_params = {k: sum(p.numel() for p in getattr(meta, k).parameters())
                for k in ("student", "teacher", "gram")}
    print(f"[M] M1 set-up {setup_s:.1f} s at {GRAM_DEPTH} blocks: parameters {n_params}, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held")
    dbatch = put_batch(batch, "cuda")  # data loading is set-up
    state = setup.state
    gram_before = meta.gram["backbone"].blocks[0].attn.qkv.weight.clone()
    t0 = time.perf_counter()
    state, m = setup.step_fn(state, dbatch, setup.scalars(0))
    torch.cuda.synchronize()
    print(f"[M] M1 warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms")
    reset_counts()
    times, steps = [], 3
    for i in range(1, steps + 1):
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, dbatch, setup.scalars(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(v) for v in m.values()), f"[M] step {i}: {m}")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: v / steps for k, v in launches.items()}
    want = gram_launches(GRAM_DEPTH)
    check(per_step == want, f"[M] launches a step {per_step} != {want}")
    check(m["gram_loss"] > 0 and m["gram_loss_weight"] == 1.0, f"[M] Gram terms {m}")
    profile = profile_step(setup, state, batch, label="M1")
    check(torch.equal(meta.gram["backbone"].blocks[0].attn.qkv.weight, gram_before),
          "[M] the steps moved the frozen Gram branch")
    refresh_gram(state)
    teacher = meta.teacher["backbone"].state_dict()
    check(all(torch.equal(v, teacher[k]) for k, v in meta.gram["backbone"].state_dict().items()),
          "[M] the refreshed Gram branch differs from the teacher's backbone")
    median = float(np.median(times))
    print(f"[M] M1 ViT-7B/16 Gram anchor at {GRAM_DEPTH} blocks, B={GRAM_B}: {steps} steps "
          f"median {median:.1f} ms (" + ", ".join(f"{t:.1f}" for t in times)
          + f"), {GRAM_B / median * 1e3:.2f} img/s, peak {peak:.2f} GiB; launches a step "
          f"{per_step}; losses at step {steps}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in m.items() if not k.startswith("grad")))
    check(peak < 75.0, f"[M] peak {peak:.2f} GiB at {GRAM_DEPTH} blocks")
    del setup, state, meta, dbatch, teacher
    return {"launches": launches, "per_step": per_step, "median_ms": median,
            "step_ms": times, "peak_gib": peak, "setup_s": setup_s, "profile": profile,
            "losses": {k: v for k, v in m.items() if not k.startswith("grad")}}


# the argument that runs phase M2 alone (phase M starts it beside M3)
M2_CHILD = "--phase-m2"


def phase_m2() -> None:
    """One step of a 2-block model at ViT-7B width with the Gram loss on
    (2 images, 512 px Gram crops resized onto the 16 x 16 grid, 4096
    prototypes, LayerScale 1) on the card and on the CPU, compared as
    phase F compares (the Gram terms with the other losses). Runs in a
    process of its own (``M2_CHILD``), beside M3."""
    card_vs_cpu_step("M2 Gram anchor", GRAM_OVERRIDES + [
        "train.batch_size_per_device=2"], config=GRAM_CONFIG)


def phase_m3() -> dict:
    """The trainer CLI on the recipe at full width cut to ``GRAM_CLI_DEPTH``
    block with ``GRAM_CLI_SMALL``'s heads, B=16: a fresh run whose
    ``gram.ckpt`` names a checkpoint written here (another seed's state,
    without a Gram branch, as a pretraining run's), 4 iterations saving at
    2 and 4 with a refresh after iteration 2 (``GRAM_CADENCE``): its step-2
    save holds that checkpoint's EMA teacher backbone as the Gram branch,
    bit for bit; then a new process resuming from that save (linked into
    its own directory, beside a torn ``tmp.3/`` and an unfinalized ``3/``)
    across the refresh to 4, its losses held by the CLI's ``--ref-losses``
    comparator and, with its final student, teacher, moments and Gram
    branch, equal to the uninterrupted run's bit for bit, the branch
    refreshed. Launches pinned a step, losses finite."""
    import torch

    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    small = GRAM_OVERRIDES + GRAM_CLI_SMALL + [f"+student.n_blocks={GRAM_CLI_DEPTH}"]
    anchor = os.path.join(M_DIR, "anchor")
    cfg = load_config(os.path.join(REPO, GRAM_CONFIG), small + ["gram.use_loss=false"],
                      n_devices=1)
    src = build_train_setup(cfg, make_synthetic_batch(cfg, 2, seed=3), device="cuda", seed=7)
    check(src.meta.gram is None, "[M] M3 the anchor's run has a Gram branch")
    saved = Checkpointer(anchor).save(1, src.state)
    anchor_teacher = {k: v.detach().cpu() for k, v in
                      src.meta.teacher["backbone"].state_dict().items()}
    del src
    gc.collect()
    torch.cuda.empty_cache()  # the children need the card's memory
    print(f"[M] M3 anchor checkpoint (seed 7, no Gram branch): {saved['bytes']} bytes in "
          f"{saved['seconds']:.1f} s")
    base = small + GRAM_CADENCE + ["checkpointing.period=2"]
    kw = dict(base=base, label="M", log_dir=M_DIR, config=GRAM_CONFIG, timeout=400)
    want = gram_launches(GRAM_CLI_DEPTH)
    a_dir, r_dir = os.path.join(M_DIR, "a"), os.path.join(M_DIR, "r")
    a = run_cli("gram anchor uninterrupted", [
        "--output-dir", a_dir, "--max-iterations", "4",
        "--record-losses", os.path.join(M_DIR, "a.jsonl")],
        overrides=[f"gram.ckpt={anchor}"], **kw)
    check(a["gram"] == "frozen" and [s["step"] for s in a["saves"]] == [2, 4]
          and a["launches"] == {k: 4 * v for k, v in want.items()}, f"[M] M3 run {a}")

    def payload(d, step):
        return torch.load(os.path.join(d, "ckpt", str(step), "state.pt"),
                          map_location="cpu", weights_only=True, mmap=True)

    a2 = payload(a_dir, 2)
    check(a2["gram"].keys() == {f"backbone.{k}" for k in anchor_teacher}
          and all(torch.equal(a2["gram"][f"backbone.{k}"], v) for k, v in anchor_teacher.items()),
          "[M] M3 the Gram branch loaded from gram.ckpt differs from the anchor's teacher")
    os.makedirs(os.path.join(r_dir, "ckpt", "2"))
    for f in os.listdir(os.path.join(a_dir, "ckpt", "2")):
        os.link(os.path.join(a_dir, "ckpt", "2", f), os.path.join(r_dir, "ckpt", "2", f))
    plant_torn_saves(os.path.join(r_dir, "ckpt"))  # the resume must pass them
    r = run_cli("gram anchor resumed", ["--output-dir", r_dir, "--max-iterations", "4",
                                        "--record-losses", os.path.join(M_DIR, "r.jsonl"),
                                        "--ref-losses", os.path.join(M_DIR, "a.jsonl")],
                overrides=[f"gram.ckpt={anchor}"], **kw)
    check(r["start_iteration"] == 2 and r["iterations"] == 4
          and r["launches"] == {k: 2 * v for k, v in want.items()}, f"[M] M3 resume {r}")
    check(r["loss_divergences"] == 0, f"[M] M3 resumed losses diverge: {r['loss_comparison']}")
    whole, resumed = read_losses(os.path.join(M_DIR, "a.jsonl")), read_losses(
        os.path.join(M_DIR, "r.jsonl"))
    check(sorted(resumed) == [2, 3] and all(resumed[i] == whole[i] for i in resumed),
          "[M] M3 the resumed losses differ from the uninterrupted run's")
    check(all(np.isfinite(v) for row in whole.values() for v in row.values())
          and all(whole[i]["gram_loss"] > 0 for i in whole), f"[M] M3 losses {whole}")
    wa, wr = payload(a_dir, 4), payload(r_dir, 4)
    for key in ("student", "teacher", "mu", "nu", "gram"):
        check(wa[key].keys() == wr[key].keys()
              and all(torch.equal(wa[key][n], wr[key][n]) for n in wa[key]),
              f"[M] M3 resumed {key} differs from the uninterrupted run's")
    check(not torch.equal(wa["gram"]["backbone.cls_token"], a2["gram"]["backbone.cls_token"]),
          "[M] M3 no refresh between the step-2 and step-4 saves")
    print(f"[M] M3 CLI, {GRAM_CLI_DEPTH}-block cut: gram.ckpt loaded the anchor's teacher "
          f"bitwise; refresh after iteration 2; resume from step 2 past torn saves in a new "
          f"process bitwise (losses, student, teacher, moments, Gram branch); save "
          f"{a['saves'][-1]['bytes']} bytes in {a['saves'][-1]['seconds']:.1f} s, restore "
          f"{r['restore_s']:.1f} s")
    del a2, wa, wr
    return {"uninterrupted": a, "resumed": r}


# ---------------------------------------------------------------- phase N

N_DIR = os.path.join(REPO, "build", "phase_n")
DISTILL_CONFIG = os.path.join("configs", "train", "vitl16_distilled.yaml")
# the recipe's images a step on one card (train.batch_size_per_device)
DISTILL_B = 16
# the one-card overrides of the recipe: no FSDP mesh (ROADMAP M7), synthetic data
DISTILL_OVERRIDES = ["parallel.fsdp=1", "data.backend=synthetic"]
# ViT-L/16 student (24 blocks, 16 heads of 64, 4 registers: 261-token
# globals, 54-token locals packed 4 to a row) and its ViT-7B/16 teacher
# (configs/train/vit7b16_pretrain.yaml: 40 blocks, 32 heads of 128, D = 4096)
DISTILL_STUDENT_DEPTH, DISTILL_TEACHER_DEPTH = 24, 40
# the teacher engine's packs: 4 rows of 2 x 261 tokens (serve.min_px =
# serve.max_px = the 256 px global crop)
TEACHER_PACK_ROWS, TEACHER_ROW_TOKENS = 4, 522
# N2 and N3's teacher: the 7B recipe at 1 block with small heads (4096
# prototypes, hidden width 2048) and LayerScale 1 (so its block reaches
# the targets), written under N_DIR; its run's checkpoint is 3.2 GB
N_TEACHER_OVERRIDES = {"n_blocks": 1, "layerscale": 1.0}
N_SMALL_HEADS = ["dino.head_n_prototypes=4096", "ibot.head_n_prototypes=4096",
                 "dino.head_hidden_dim=2048", "ibot.head_hidden_dim=2048"]
# N3's student depth: a save of its student, moments and teacher is ~1.6 GB
N_CLI_DEPTH = 4


def distill_launches(student: int, teacher: int, source: str = "in_step") -> dict:
    """K1-K5 launches of one distillation step: K1 once a student block and,
    in the step (``in_step``), once a teacher block; K4 twice a block in each
    backbone plus the student's final and local-CLS norms and the teacher's
    prefix and patch norms (its untied CLS norms); K2, K3 once a student
    block, K5 once a student K4 launch. The recipe sets no remat."""
    t = teacher if source == "in_step" else 0
    return {"K1": student + t, "K2": student, "K3": student,
            "K4": 2 * student + 2 + (2 * t + 2 if t else 0), "K5": 2 * student + 2}


def teacher_pack_launches(teacher: int) -> dict:
    """K1 and K4 launches of one teacher-engine pack: K1 once a block, K4
    twice a block plus the prefix and patch norms."""
    return {"K1": teacher, "K2": 0, "K3": 0, "K4": 2 * teacher + 2, "K5": 0}


def n_teacher_yaml(directory: str = N_DIR) -> str:
    """The 1-block, small-headed ViT-7B teacher recipe of N2 and N3 (and O1,
    O3), written under ``directory``."""
    import yaml

    with open(os.path.join(REPO, "configs", "train", "vit7b16_pretrain.yaml")) as f:
        recipe = yaml.safe_load(f)
    recipe["student"].update(N_TEACHER_OVERRIDES)
    for head in ("dino", "ibot"):
        recipe[head].update(head_n_prototypes=4096, head_hidden_dim=2048)
    path = os.path.join(directory, "teacher_7b_1block.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return path


def phase_n() -> dict:
    """Distillation at the recipe's widths and the teacher's full depth on
    one card (module docstring)."""
    import torch

    from dinov3_tpu_torch.train.multidistillation import _SHARED_TEACHERS

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(N_DIR, ignore_errors=True)
    os.makedirs(N_DIR)
    children = []
    try:
        out = {}
        t0 = time.perf_counter()
        out["N0"], setup, batch = phase_n0()
        print(f"[N] N0 {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["N1"] = phase_n1(setup, batch)
        print(f"[N] N1 {time.perf_counter() - t0:.1f} s")
        del setup, batch
        _SHARED_TEACHERS.clear()
        gc.collect()
        torch.cuda.empty_cache()
        # N2's CPU half takes the host's cores and N3's children wait
        # mostly on the card and the disk: N2 runs in a process of its own
        t0 = time.perf_counter()
        yaml_path = n_teacher_yaml()
        children.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), N2_CHILD, yaml_path], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        out["N3"] = phase_n3(yaml_path, children)
        print(f"[N] N3 {time.perf_counter() - t0:.1f} s")
        n2_out, _ = children[0].communicate(timeout=600)
        print(n2_out.rstrip())
        check(children[0].returncode == 0, f"[N] N2 exit {children[0].returncode}")
        print(f"[N] N2 and N3 {time.perf_counter() - t0:.1f} s")
        return out
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        _SHARED_TEACHERS.clear()
        shutil.rmtree(N_DIR, ignore_errors=True)


def distill_student_seg():
    """The seg plane [R, 261] of the student's packed pass at the recipe's
    B=16 (2B global rows, 4 local crops of 54 tokens a packed row; the
    recipe has no drop path, so every row)."""
    from dinov3_tpu_torch.ops.packing import make_packed_layout, packed_segment_ids

    layout = make_packed_layout(n_global_rows=2 * DISTILL_B, n_local=8 * DISTILL_B,
                                seq_global=GRAM_N, seq_local=GRAM_N_LOCAL, n_prefix=5)
    return packed_segment_ids(layout)


def teacher_pack_seg(teacher_cfg, n_images: int = 8):
    """The seg plane [4, 522] of one teacher-engine pack: 256 px global
    crops, two a row, from the port's own batcher on the teacher's layout."""
    from dinov3_tpu_torch.serve import ContinuousBatcher, ServeRequest, serve_layout_from_cfg

    layout = serve_layout_from_cfg(teacher_cfg)
    batcher = ContinuousBatcher(layout)
    rng = np.random.default_rng(5)
    for i in range(n_images):
        batcher.admit(ServeRequest(request_id=i, image=rng.standard_normal(
            (256, 256, 3)).astype(np.float32)))
    seg = batcher.next_pack().planes["seg"].copy()
    check(seg.shape == (TEACHER_PACK_ROWS, TEACHER_ROW_TOKENS),
          f"[N] teacher pack seg {seg.shape}")
    return seg


def phase_n_kernels() -> dict:
    """K1-K5 against their plain versions at this path's new shapes: K1 on
    the student's packed rows at B=16 (ids, head_dim 64), the in-step
    teacher's [2B x 32, 261, 128] (no ids) and the teacher engine's pack
    [4 x 32, 522, 128] (ids); K2, K3 on the student's rows; K4 at D = 1024
    on a student block's rows, at D = 4096 on the teacher's rows and a
    pack's; K5 on a student block's rows."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.train.distillation import resolve_distillation_cfg

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(17)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    def qkv_views(rows, n, heads, d):
        qkv = randn(rows, n, 3 * heads * d)
        q, k, v = (qkv[..., i * heads * d:(i + 1) * heads * d].reshape(rows, n, heads, d)
                   for i in range(3))
        return q.contiguous(), k.contiguous(), v

    cfg = load_config(os.path.join(REPO, DISTILL_CONFIG), DISTILL_OVERRIDES, n_devices=1)
    tcfg = resolve_distillation_cfg(cfg)
    tcfg.serve.min_px = tcfg.serve.max_px = 256
    out = {k: {} for k in ("K1", "K2", "K3", "K4", "K5")}
    seg = torch.from_numpy(distill_student_seg()).to(dev)
    R = seg.shape[0]
    q, k, v = qkv_views(R, GRAM_N, 16, 64)
    label = f"ViT-L student B={DISTILL_B} [{R}x16, {GRAM_N}, 64] bf16 seg"
    out["K1"]["student"] = check_flash(q, k, v, seg, label, time_it=True)
    bwd = check_flash_bwd(q, k, v, seg, label, time_it=True)
    out["K2"]["student"], out["K3"]["student"] = bwd["K2"], bwd["K3"]
    del q, k, v
    q, k, v = qkv_views(2 * DISTILL_B, GRAM_N, GRAM_H, 128)
    out["K1"]["teacher"] = check_flash(
        q, k, v, None, f"ViT-7B in-step teacher [{2 * DISTILL_B}x{GRAM_H}, {GRAM_N}, 128] "
        "bf16 no seg", time_it=True)
    del q, k, v
    pseg = torch.from_numpy(teacher_pack_seg(tcfg)).to(dev)
    q, k, v = qkv_views(TEACHER_PACK_ROWS, TEACHER_ROW_TOKENS, GRAM_H, 128)
    out["K1"]["teacher pack"] = check_flash(
        q, k, v, pseg, f"ViT-7B teacher engine pack [{TEACHER_PACK_ROWS}x{GRAM_H}, "
        f"{TEACHER_ROW_TOKENS}, 128] bf16 seg", time_it=True)
    del q, k, v
    for name, rows, d in (("student block", R * GRAM_N, 1024),
                          ("teacher", 2 * DISTILL_B * GRAM_N, GRAM_D),
                          ("teacher pack", TEACHER_PACK_ROWS * TEACHER_ROW_TOKENS, GRAM_D)):
        s_, b_ = (torch.randn(d, generator=g) * 0.5 + 1).to(dev), torch.randn(
            d, generator=g).to(dev)
        out["K4"][name] = check_layernorm(randn(rows, d) * 3 + 1, s_, b_,
                                          f"{name} [{rows}, {d}] bf16, fp32 params",
                                          time_it=True)
    s_ = (torch.randn(1024, generator=g) * 0.5 + 1).to(dev)
    out["K5"]["student block"] = check_layernorm_bwd(
        randn(R * GRAM_N, 1024) * 3 + 1, s_,
        f"ViT-L student block [{R * GRAM_N}, 1024] bf16, fp32 scale", time_it=True)
    return out


def _param_digest(module) -> list:
    """Each parameter's version counter (bumped by any in-place write) and
    the int64 sum of its bits as int32 words, taken on the card."""
    import torch

    return [(p._version, p.detach().view(torch.int32).sum(dtype=torch.int64).item())
            for p in module.parameters()]


def phase_n0() -> tuple:
    """The recipe's step (``vitl16_distilled.yaml`` with
    ``DISTILL_OVERRIDES``: ViT-L/16 student at B=16, 262,144 / 98,304
    prototypes) with its ViT-7B teacher at 40 blocks, drawn on the card,
    in the step: ``build_train_setup`` + ``step_fn``, 2 warm-up steps and 5
    timed, every loss finite, the launches pinned a step, one more step
    profiled by kernel class, the teacher unchanged by the steps. Returns
    (record, setup, batch) for N1."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup, put_batch

    kernels = phase_n_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = load_config(os.path.join(REPO, DISTILL_CONFIG), DISTILL_OVERRIDES, n_devices=1)
    batch = make_synthetic_batch(cfg, DISTILL_B, seed=0)
    check(batch["global_crops"].shape == (2 * DISTILL_B, 256, 256, 3)
          and batch["local_crops"].shape == (8 * DISTILL_B, 112, 112, 3),
          f"[N] batch {[(k, v.shape) for k, v in batch.items()]}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = build_train_setup(cfg, batch, device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    meta = setup.meta
    tb, sb = meta.teacher["backbone"], meta.student["backbone"]
    check(meta.distillation and meta.teacher_source == "in_step"
          and (tb.n_blocks, tb.embed_dim, tb.head_dim) == (DISTILL_TEACHER_DEPTH, GRAM_D, 128)
          and (sb.n_blocks, sb.embed_dim, sb.head_dim) == (DISTILL_STUDENT_DEPTH, 1024, 64)
          and next(tb.parameters()).device.type == "cuda",
          "[N] the set-up did not resolve a 40-block ViT-7B teacher and a ViT-L student")
    n_params = {k: sum(p.numel() for p in getattr(meta, k).parameters())
                for k in ("student", "teacher")}
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"[N] N0 set-up {setup_s:.1f} s (teacher drawn on the card): parameters "
          f"{n_params}, {held:.2f} GiB held")
    dbatch = put_batch(batch, "cuda")  # data loading is set-up
    digest = _param_digest(meta.teacher)
    sample = {n: p.detach().clone() for n, p in meta.teacher.named_parameters()
              if n.startswith(("backbone.blocks.0.", "backbone.blocks.39.", "dino_head.mlp.0",
                               "ibot_head.last_layer"))}
    state = setup.state
    for i in range(2):
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, dbatch, setup.scalars(i))
        torch.cuda.synchronize()
        print(f"[N] N0 warm-up step {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    reset_counts()
    times, steps = [], 5
    for i in range(2, 2 + steps):
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, dbatch, setup.scalars(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(v) for v in m.values()), f"[N] step {i}: {m}")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: v / steps for k, v in launches.items()}
    want = distill_launches(DISTILL_STUDENT_DEPTH, DISTILL_TEACHER_DEPTH)
    check(per_step == want, f"[N] launches a step {per_step} != {want}")
    profile = profile_step(setup, state, batch, label="N0")
    check(_param_digest(meta.teacher) == digest
          and all(torch.equal(p, sample[n]) for n, p in meta.teacher.named_parameters()
                  if n in sample),
          "[N] the steps moved the frozen teacher")
    median = float(np.median(times))
    print(f"[N] N0 ViT-L/16 <- ViT-7B/16 ({DISTILL_TEACHER_DEPTH} blocks) in the step, "
          f"B={DISTILL_B}: {steps} steps median {median:.1f} ms ("
          + ", ".join(f"{t:.1f}" for t in times)
          + f"), {DISTILL_B / median * 1e3:.2f} img/s, peak {peak:.2f} GiB; launches a step "
          f"{per_step}; the teacher unchanged (version counters, bit sums, "
          f"{len(sample)} tensors compared); losses at step {2 + steps - 1}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in m.items() if not k.startswith("grad")))
    setup.state = state
    return ({"kernels": kernels, "launches": launches, "per_step": per_step,
             "median_ms": median, "step_ms": times, "peak_gib": peak, "setup_s": setup_s,
             "profile": profile,
             "held_gib": held, "losses": {k: v for k, v in m.items()
                                          if not k.startswith("grad")}},
            setup, batch)


def phase_n1(setup, batch) -> dict:
    """The serve arm on N0's teacher in the same process: the shared
    ``TeacherServer`` built from the state's teacher (cast to bf16 on the
    card), its planes for the batch's global crops against the in-step
    teacher's features (bf16; K1 with ids against K1 without: 2^-5 of the
    largest magnitude), a replay of the same crops with no new forward and
    the same bits, the engine's img/s at 256 px and one batch of misses
    profiled, 3 steps reading the planes (launches pinned) and a fourth
    profiled, and a second student's config (the ViT-B/16
    multidistillation student) getting the same server."""
    import torch

    from dinov3_tpu_torch.configs import apply_dot_overrides
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import put_batch
    from dinov3_tpu_torch.train.multidistillation import (
        setup_multidistillation,
        shared_teacher_server,
    )

    meta = setup.meta
    cfg = copy.deepcopy(setup.cfg)
    cfg.distillation.teacher_source = "serve"
    sd = meta.teacher["backbone"].state_dict()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server = shared_teacher_server(cfg, teacher_params=sd, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"[N] N1 teacher server built in {build_s:.1f} s (bf16 cast on the card, "
          f"fingerprint {server.fingerprint}); "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held")
    cls, patches = meta.teacher_backbone_features(put_batch(batch, "cuda"))
    reset_counts()
    t0 = time.perf_counter()
    ann = server.annotate(batch)
    first_s = time.perf_counter() - t0
    pack = read_counts()
    packs = server.engine.packs_run
    per_pack = {k: v / packs for k, v in pack.items()}
    want = teacher_pack_launches(DISTILL_TEACHER_DEPTH)
    check(per_pack == want, f"[N] teacher pack launches {per_pack} != {want}")
    errs = {}
    for name, got, ref in (("cls", ann["teacher_cls"], cls),
                           ("patches", ann["teacher_patches"], patches)):
        ref = ref.float().cpu().numpy()
        errs[name] = float(np.abs(got - ref).max())
        tol = 2.0 ** -5 * float(np.abs(ref).max())
        check(got.shape == ref.shape and errs[name] <= tol,
              f"[N] served teacher {name} vs in-step: {errs[name]:.4g} > {tol:.4g}")
    print(f"[N] N1 served planes vs the in-step teacher (bf16, K1 with ids vs without): "
          f"max|cls| err {errs['cls']:.4g}, max|patches| err {errs['patches']:.4g} "
          f"(tol 2^-5 of the largest magnitude)")
    forwards = server.teacher_forwards
    t0 = time.perf_counter()
    again = server.annotate(batch)
    hit_s = time.perf_counter() - t0
    check(server.teacher_forwards == forwards
          and all(np.array_equal(again[k], ann[k]) for k in ("teacher_cls", "teacher_patches")),
          "[N] a replay forwarded again or changed the planes")
    n = 2 * DISTILL_B
    # steps on the serve arm: the same meta-arch reading the batch's planes
    fresh = [make_synthetic_batch(setup.cfg, DISTILL_B, seed=seed) for seed in (1, 2, 3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [ann] + [server.annotate(b) for b in fresh[:2]]  # all misses
    miss_s = (time.perf_counter() - t0) / 2
    # one batch of misses through the engine, under the profiler
    engine_profile = device_busy(lambda: server.annotate(fresh[2]), "N1 teacher engine")
    meta.teacher_source = "serve"
    try:
        state = setup.state
        reset_counts()
        times = []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            state, m = setup.step_fn(state, put_batch(b, "cuda"), setup.scalars(10 + i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check(all(np.isfinite(v) for v in m.values()), f"[N] serve step {i}: {m}")
        steps = read_counts()
        step_profile = profile_step(setup, state, batches[-1], label="N1 serve arm")
    finally:
        meta.teacher_source = "in_step"
    per_step = {k: v / len(batches) for k, v in steps.items()}
    want = distill_launches(DISTILL_STUDENT_DEPTH, DISTILL_TEACHER_DEPTH, "serve")
    check(per_step == want, f"[N] serve-arm launches a step {per_step} != {want}")
    stats = server.stats()
    check(stats["compile_count"] == 1 and stats["teacher_forwards"] == 4 * n
          and stats["requests"] == 5 * n, f"[N] server stats {stats}")
    # a second student of the same teacher (the spec's ViT-B/16) shares it
    md = copy.deepcopy(cfg)
    apply_dot_overrides(md, ["multidistillation.enabled=true"])
    md.multidistillation.students = [{
        "name": "vitb", "ranks_range": [0, 1],
        "config_path": os.path.join(REPO, "configs", "train", "multidist_tests",
                                    "vitb_p16.yaml")}]
    other = setup_multidistillation(md, 0, 1, N_DIR,
                                    extra_overrides=["crops.global_crops_size=256"]).cfg
    check(other.student.arch == "vit_base"
          and shared_teacher_server(other, teacher_params=sd, device="cuda") is server,
          "[N] a second student of the same teacher got another server")
    print(f"[N] N1 teacher engine at 256 px: {n / miss_s:.1f} img/s on misses "
          f"({miss_s * 1e3:.1f} ms for {n} crops in {packs} packs; the first batch "
          f"{first_s * 1e3:.1f} ms), {n / hit_s:.1f} img/s on hits; pack launches "
          f"{per_pack}; serve-arm steps "
          + ", ".join(f"{t:.1f}" for t in times) + f" ms, launches a step {per_step}; "
          f"stats {stats}; a ViT-B/16 student of the same teacher got the same server")
    setup.state = state
    return {"build_s": build_s, "miss_img_s": n / miss_s, "hit_img_s": n / hit_s,
            "first_batch_s": first_s, "engine_profile": engine_profile,
            "step_profile": step_profile,
            "packs": packs, "per_pack": per_pack, "pack_launches": pack,
            "step_launches": steps, "per_step": per_step, "step_ms": times,
            "errs": errs, "stats": stats}


# the argument that runs phase N2 alone (phase N starts it beside N3)
N2_CHILD = "--phase-n2"


def phase_n2(teacher_yaml: str) -> None:
    """One distillation step of a 2-block ViT-L-width student (2 images,
    4096 prototypes, LayerScale 1) from a 1-block ViT-7B-width teacher on
    the card and on the CPU, the same weights (the teacher drawn on the
    card, copied to the CPU's), compared as phase F compares. Runs in a
    process of its own (``N2_CHILD``), beside N3."""
    card_vs_cpu_step("N2 distillation", DISTILL_OVERRIDES + [
        "train.batch_size_per_device=2", f"distillation.full_cfg_path={teacher_yaml}"],
        config=DISTILL_CONFIG)


def phase_n3(teacher_yaml: str, children: list) -> dict:
    """The trainer CLI on the recipe with its student cut to
    ``N_CLI_DEPTH`` blocks and small heads, from a teacher checkpoint
    written here (the 1-block ViT-7B-width recipe's own run, seed 7):
    4 iterations with ``teacher_source=serve``, saving at 2 and 4, the
    teacher its checkpoint's bit for bit; a resume from the step-2 save
    (linked beside torn saves) in a new process, held by ``--ref-losses``
    and bitwise; ``--self-check`` (in a process started beside the run)
    reporting ``distillation_teacher_frozen``. Launches pinned: the
    student's serve-arm steps plus the teacher engine's packs."""
    import torch

    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.train import build_train_setup

    anchor = os.path.join(N_DIR, "teacher_run")
    base = DISTILL_OVERRIDES + N_SMALL_HEADS + [
        f"+student.n_blocks={N_CLI_DEPTH}", "checkpointing.period=2",
        f"distillation.full_cfg_path={teacher_yaml}", f"distillation.checkpoint_path={anchor}",
        "distillation.teacher_source=serve"]
    kw = dict(base=base, label="N", log_dir=N_DIR, config=DISTILL_CONFIG, timeout=400)
    sc_cmd = [sys.executable, "-m", "dinov3_tpu_torch.train.train", "--config-file",
              DISTILL_CONFIG, "--output-dir", os.path.join(N_DIR, "sc"), "--self-check", *base]
    children.append(subprocess.Popen(sc_cmd, cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
    tcfg = load_config(teacher_yaml, DISTILL_OVERRIDES, n_devices=1)
    src = build_train_setup(tcfg, make_synthetic_batch(tcfg, 2, seed=3), device="cuda", seed=7)
    saved = Checkpointer(anchor).save(1, src.state)
    teacher = {k: v.detach().cpu() for k, v in src.meta.teacher.state_dict().items()}
    del src
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[N] N3 teacher checkpoint (the 1-block ViT-7B-width recipe's run, seed 7): "
          f"{saved['bytes']} bytes in {saved['seconds']:.1f} s")
    a_dir, r_dir = os.path.join(N_DIR, "a"), os.path.join(N_DIR, "r")
    a = run_cli("distill uninterrupted", [
        "--output-dir", a_dir, "--max-iterations", "4",
        "--record-losses", os.path.join(N_DIR, "a.jsonl")], **kw)
    n = 2 * DISTILL_B
    packs = -(-n // (2 * TEACHER_PACK_ROWS))  # a batch's crops, two a row

    def launches(steps: int, batches: int) -> dict:
        s = distill_launches(N_CLI_DEPTH, 1, "serve")
        p = teacher_pack_launches(1)
        return {k: steps * s[k] + batches * packs * p[k] for k in s}

    ts = a["teacher_serve"]
    check(a["distillation"] == "serve" and [s["step"] for s in a["saves"]] == [2, 4]
          and a["launches"] == launches(4, 5), f"[N] N3 run {a}")
    check(ts["requests"] == 5 * n and ts["teacher_forwards"] == 5 * n
          and ts["compile_count"] == 1, f"[N] N3 teacher_serve {ts}")

    def payload(d, step):
        return torch.load(os.path.join(d, "ckpt", str(step), "state.pt"),
                          map_location="cpu", weights_only=True, mmap=True)

    wa = payload(a_dir, 4)
    check(wa["teacher"].keys() == teacher.keys()
          and all(torch.equal(wa["teacher"][k], v) for k, v in teacher.items()),
          "[N] N3 the run's teacher is not its checkpoint's")
    os.makedirs(os.path.join(r_dir, "ckpt", "2"))
    for f in os.listdir(os.path.join(a_dir, "ckpt", "2")):
        os.link(os.path.join(a_dir, "ckpt", "2", f), os.path.join(r_dir, "ckpt", "2", f))
    plant_torn_saves(os.path.join(r_dir, "ckpt"))
    r = run_cli("distill resumed", ["--output-dir", r_dir, "--max-iterations", "4",
                                    "--record-losses", os.path.join(N_DIR, "r.jsonl"),
                                    "--ref-losses", os.path.join(N_DIR, "a.jsonl")], **kw)
    check(r["start_iteration"] == 2 and r["iterations"] == 4
          and r["launches"] == launches(2, 3) and r["loss_divergences"] == 0,
          f"[N] N3 resume {r}")
    whole, resumed = read_losses(os.path.join(N_DIR, "a.jsonl")), read_losses(
        os.path.join(N_DIR, "r.jsonl"))
    check(sorted(resumed) == [2, 3] and all(resumed[i] == whole[i] for i in resumed)
          and all(np.isfinite(v) for row in whole.values() for v in row.values()),
          "[N] N3 the resumed losses differ from the uninterrupted run's")
    wr = payload(r_dir, 4)
    for key in ("student", "teacher", "mu", "nu"):
        check(wa[key].keys() == wr[key].keys()
              and all(torch.equal(wa[key][k], wr[key][k]) for k in wa[key]),
              f"[N] N3 resumed {key} differs from the uninterrupted run's")
    sc_out, _ = children[-1].communicate(timeout=400)
    with open(os.path.join(N_DIR, "self_check.log"), "w") as f:
        f.write(sc_out)
    check(children[-1].returncode == 0, f"[N] N3 self-check exit {children[-1].returncode}:\n"
          + "\n".join(sc_out.splitlines()[-30:]))
    sc = json.loads(sc_out.strip().splitlines()[-1])
    check(sc["self_check_failures"] == 0 and sc["check/distillation_teacher_frozen"] is True,
          f"[N] N3 self-check {sc}")
    print(f"[N] N3 CLI ({N_CLI_DEPTH}-block student, 1-block teacher, serve arm): the "
          f"teacher loaded from its checkpoint bitwise; resume from step 2 past torn saves "
          f"in a new process bitwise (losses, student, teacher, moments); teacher_serve {ts}; "
          f"self-check {sum(k.startswith('check/') for k in sc)} checks passed, "
          "distillation_teacher_frozen")
    del wa, wr
    return {"uninterrupted": a, "resumed": r, "self_check": sc}


# ---------------------------------------------------------------- phase O

O_DIR = os.path.join(REPO, "build", "phase_o")
# ConvNeXt-L/16 distilled from the ViT-7B/16: the distilled recipe with the
# student swapped on the command line (its widths, crops, heads and teacher
# as written; no file under configs/ names a ConvNeXt)
CONVNEXT_OVERRIDES = DISTILL_OVERRIDES + ["student.arch=convnext_large"]
CONVNEXT_DEPTHS, CONVNEXT_DIMS = (3, 3, 27, 3), (192, 384, 768, 1536)
# the LayerNorms of one ConvNeXt forward: the stem's, the three
# downsamples', one a block and the final norm
CONVNEXT_NORMS = 1 + 3 + sum(CONVNEXT_DEPTHS) + 1
# O1's cut: one block a stage at ConvNeXt-L widths
O1_DEPTHS = "+student.depths=[1,1,1,1]"
O1_CHILD = "--phase-o1"
O1_ARMS = ("ssl", "distill")
VIT7B_CONFIG = os.path.join("configs", "train", "vit7b16_pretrain.yaml")
# the 7B at 224 px: 1 CLS + 4 storage tokens + 14 x 14 patches
VIT7B_EVAL_N = 5 + (EVAL_PX // 16) ** 2


def convnext_launches(norms: int, teacher: int = 0, ema: bool = False) -> dict:
    """K1-K5 launches of one step with a ConvNeXt student of ``norms``
    LayerNorms a forward, run over the global and the local crops in two
    passes: K4 once a norm a pass and K5 once a K4 launch; a ViT teacher of
    ``teacher`` blocks in the step adds K1 once a block and K4 twice a block
    plus its prefix and patch norms; an EMA ConvNeXt teacher (``ema``) K4
    once a norm over the global crops. K2 and K3 never: no student
    attention, a teacher without gradients."""
    k4 = 2 * norms + (2 * teacher + 2 if teacher else 0) + (norms if ema else 0)
    return {"K1": teacher, "K2": 0, "K3": 0, "K4": k4, "K5": 2 * norms}


def convnext_forward_flops(model, px: int) -> float:
    """Operations of one px x px image through a ConvNeXt forward, counted
    from its modules (two a multiply-add): the stem and downsample convs,
    each block's 7 x 7 depthwise conv and its two pointwise Denses, at each
    stage's SAME-padded size."""
    from dinov3_tpu_torch.models.convnext import same_pads

    flops, n, c_in = 0.0, px, model.in_chans
    for i, (depth, c) in enumerate(zip(model.depths, model.dims)):
        k = 4 if i == 0 else 2
        n = (n + sum(same_pads(n, k, k))) // k
        flops += 2 * n * n * k * k * c_in * c
        flops += depth * 2 * n * n * c * (49 + 8 * c)
        c_in = c
    return flops


CONV_CLASSES = (("conv (depthwise, stem, downsample; fwd/bwd)",
                 ("conv", "fprop", "dgrad", "wgrad", "depthwise", "implicit")),
                ("copy (layout / dtype)", ("copy_kernel", "direct_copy", "catarray")))


def phase_o() -> dict:
    """The ConvNeXt family and the ViT-7B eval extraction on one card
    (module docstring)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(O_DIR, ignore_errors=True)
    os.makedirs(O_DIR)
    children = []
    try:
        out = {}
        t0 = time.perf_counter()
        out["O0"] = phase_o0()
        print(f"[O] O0 {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["O2"] = phase_o2()
        print(f"[O] O2 {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        # O1's CPU halves take the host's cores and O3's child waits mostly
        # on the card and the disk: O1's two arms run in processes of their
        # own, beside O3
        t0 = time.perf_counter()
        yaml_path = n_teacher_yaml(O_DIR)
        for arm in O1_ARMS:
            children.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), O1_CHILD, arm, yaml_path],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        out["O3"] = phase_o3(yaml_path)
        print(f"[O] O3 {time.perf_counter() - t0:.1f} s")
        for arm, child in zip(O1_ARMS, children):
            o1_out, _ = child.communicate(timeout=600)
            print(o1_out.rstrip())
            check(child.returncode == 0, f"[O] O1 {arm} exit {child.returncode}")
        print(f"[O] O1 and O3 {time.perf_counter() - t0:.1f} s")
        return out
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(O_DIR, ignore_errors=True)


def phase_o_kernels() -> dict:
    """K4 and K5 against their plain versions at the ConvNeXt-L student's
    new widths: each stage's rows of the recipe's 2B = 32 global crops at
    256 px ([32 x 64 x 64, 192] down to [32 x 8 x 8, 1536], the stem's and
    the blocks' norms), and K4 on the final norm's [32 x 257, 1536]."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(19)
    out = {"K4": {}, "K5": {}}
    n_img, side = 2 * DISTILL_B, 256 // 4
    shapes = [(f"stage {i}", n_img * (side >> i) ** 2, c) for i, c in enumerate(CONVNEXT_DIMS)]
    for name, rows, d in shapes + [("final norm", n_img * (1 + 16 * 16), CONVNEXT_DIMS[-1])]:
        x = (torch.randn(rows, d, generator=g) * 3 + 1).to(dev, torch.bfloat16)
        s_ = (torch.randn(d, generator=g) * 0.5 + 1).to(dev)
        b_ = torch.randn(d, generator=g).to(dev)
        label = f"ConvNeXt-L {name} [{rows}, {d}] bf16, fp32 params"
        out["K4"][name] = check_layernorm(x, s_, b_, label, time_it=True)
        if name != "final norm":
            out["K5"][name] = check_layernorm_bwd(x, s_, label, time_it=True)
        del x
    return out


def phase_o0() -> dict:
    """The distilled recipe with a ConvNeXt-L student (``CONVNEXT_OVERRIDES``:
    B=16, 2 x 256 px + 8 x 112 px crops, 262,144 / 98,304 prototypes) and
    its ViT-7B/16 teacher at 40 blocks drawn on the card, in the step:
    ``build_train_setup`` + ``step_fn``, a warm-up step and 5 timed, every
    loss finite, the launches pinned a step, one step profiled by kernel
    class with the convolutions and the copies as classes of their own."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.models import ConvNeXt
    from dinov3_tpu_torch.train import build_train_setup, put_batch

    kernels = phase_o_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = load_config(os.path.join(REPO, DISTILL_CONFIG), CONVNEXT_OVERRIDES, n_devices=1)
    batch = make_synthetic_batch(cfg, DISTILL_B, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup = build_train_setup(cfg, batch, device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    meta = setup.meta
    tb, sb = meta.teacher["backbone"], meta.student["backbone"]
    check(meta.distillation and meta.teacher_source == "in_step"
          and isinstance(sb, ConvNeXt)
          and (sb.depths, sb.dims) == (CONVNEXT_DEPTHS, CONVNEXT_DIMS)
          and not (meta.crop_packing or meta.rng_plan)
          and (tb.n_blocks, tb.embed_dim, tb.head_dim) == (DISTILL_TEACHER_DEPTH, GRAM_D, 128)
          and next(tb.parameters()).device.type == "cuda",
          "[O] the set-up did not resolve a ConvNeXt-L student and a 40-block ViT-7B teacher")
    n_params = {k: sum(p.numel() for p in getattr(meta, k).parameters())
                for k in ("student", "teacher")}
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"[O] O0 set-up {setup_s:.1f} s (student modules and draws on the host "
          f"{setup.draws_s:.1f} s of it, the teacher drawn on the card): parameters "
          f"{n_params}, {held:.2f} GiB held")
    dbatch = put_batch(batch, "cuda")  # data loading is set-up
    state = setup.state
    t0 = time.perf_counter()
    state, m = setup.step_fn(state, dbatch, setup.scalars(0))
    torch.cuda.synchronize()
    print(f"[O] O0 warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    reset_counts()
    times, steps = [], 5
    for i in range(1, 1 + steps):
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, dbatch, setup.scalars(i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(v) for v in m.values()), f"[O] step {i}: {m}")
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: v / steps for k, v in launches.items()}
    want = convnext_launches(CONVNEXT_NORMS, DISTILL_TEACHER_DEPTH)
    check(per_step == want, f"[O] launches a step {per_step} != {want}")
    profile = profile_step(setup, state, batch, label="O0", extra_classes=CONV_CLASSES)
    median = float(np.median(times))
    print(f"[O] O0 ConvNeXt-L/16 <- ViT-7B/16 ({DISTILL_TEACHER_DEPTH} blocks) in the step, "
          f"B={DISTILL_B}: {steps} steps median {median:.1f} ms ("
          + ", ".join(f"{t:.1f}" for t in times)
          + f"), {DISTILL_B / median * 1e3:.2f} img/s, peak {peak:.2f} GiB; launches a step "
          f"{per_step}; losses at step {steps}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in m.items() if not k.startswith("grad")))
    del setup, state, dbatch, meta, tb, sb
    return {"kernels": kernels, "launches": launches, "per_step": per_step,
            "median_ms": median, "step_ms": times, "peak_gib": peak, "setup_s": setup_s,
            "profile": profile, "held_gib": held,
            "losses": {k: v for k, v in m.items() if not k.startswith("grad")}}


def phase_o2() -> dict:
    """Eval extraction at B=256, 224 px, drawn on the card by
    ``build_model_for_eval`` (built on the meta device): ConvNeXt-L, then
    the ViT-7B/16 of ``vit7b16_pretrain.yaml`` at its 40 blocks; set-up s,
    img/s, the share of the 989 TFLOP/s cap and the launches a forward; K1
    and K4 at the 7B's eval shapes against their plain versions."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.models import ConvNeXt, build_model_for_eval

    out = {}
    cfg = load_config(os.path.join(REPO, DISTILL_CONFIG), CONVNEXT_OVERRIDES, n_devices=1)
    t0 = time.perf_counter()
    model = build_model_for_eval(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(isinstance(model, ConvNeXt) and model.dims == CONVNEXT_DIMS
          and next(model.parameters()).device.type == "cuda", "[O2] not ConvNeXt-L on the card")
    print(f"[O2] ConvNeXt-L eval model built on the meta device, drawn on the card: "
          f"{setup_s:.2f} s")
    out["convnext"] = extract_timed(
        "O2 ConvNeXt-L", model, convnext_forward_flops(model, EVAL_PX), seeded_batches(5),
        {"K1": 0, "K2": 0, "K3": 0, "K4": CONVNEXT_NORMS, "K5": 0})
    out["convnext"]["setup_s"] = setup_s
    del model
    gc.collect()
    torch.cuda.empty_cache()
    vcfg = load_config(os.path.join(REPO, VIT7B_CONFIG), ["parallel.fsdp=1"], n_devices=1)
    t0 = time.perf_counter()
    model = build_model_for_eval(vcfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check((model.n_blocks, model.embed_dim, model.head_dim, model.n_prefix)
          == (DISTILL_TEACHER_DEPTH, GRAM_D, 128, 5), "[O2] not the 40-block ViT-7B/16")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[O2] ViT-7B/16 eval model ({n_params} parameters, "
          f"{next(model.parameters()).dtype}) built on the meta device, drawn on the card: "
          f"{setup_s:.2f} s, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held")
    flops = forward_flops(model, VIT7B_EVAL_N)
    out["vit7b"] = extract_timed(
        "O2 ViT-7B/16", model, flops, seeded_batches(3),
        {"K1": DISTILL_TEACHER_DEPTH, "K2": 0, "K3": 0, "K4": 2 * DISTILL_TEACHER_DEPTH + 2,
         "K5": 0})
    out["vit7b"]["setup_s"] = setup_s
    del model
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(29)
    N, H, D = VIT7B_EVAL_N, GRAM_H, 128
    qkv = torch.randn(EVAL_B, N, 3 * H * D, generator=g).to("cuda", torch.bfloat16)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(EVAL_B, N, H, D) for i in range(3))
    out["K1"] = check_flash(q.contiguous(), k.contiguous(), v, None,
                            f"ViT-7B eval [{EVAL_B}x{H}, {N}, {D}] bf16 no seg", time_it=True)
    del qkv, q, k, v
    xr = (torch.randn(EVAL_B * N, GRAM_D, generator=g) * 3 + 1).to("cuda", torch.bfloat16)
    s_, b_ = torch.randn(GRAM_D, generator=g) * 0.5 + 1, torch.randn(GRAM_D, generator=g)
    out["K4"] = check_layernorm(xr, s_.to("cuda"), b_.to("cuda"),
                                f"ViT-7B eval rows [{EVAL_B * N}, {GRAM_D}] bf16, fp32 params",
                                time_it=True)
    del xr
    return out


def phase_o1(arm: str, teacher_yaml: str) -> None:
    """A step at ConvNeXt-L widths with one block a stage (4096 prototypes,
    B=2, LayerScale 1) on the card and on the CPU, compared as phase F
    compares: ``arm`` "distill" distils from the 1-block ViT-7B-width
    teacher of ``teacher_yaml``; "ssl" steps with its EMA ConvNeXt
    teacher and drop path at rate 0.2, then its card state after the step is saved and read back by
    ``build_model_for_eval(ckpt_dir=)`` on the card: the EMA teacher's
    backbone bit for bit, its features within 2^-5. Each arm runs in a
    process of its own (``O1_CHILD``), beside O3."""
    import torch

    from dinov3_tpu_torch.checkpoint import Checkpointer
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.models import build_model_for_eval

    base = CONVNEXT_OVERRIDES + [O1_DEPTHS, "train.batch_size_per_device=2"]
    if arm == "distill":
        card_vs_cpu_step("O1 ConvNeXt <- ViT-7B width", base + [
            f"distillation.full_cfg_path={teacher_yaml}"], config=DISTILL_CONFIG,
            n_blocks=None)
        return
    # drop path on (the distilled recipe has none): the per-sample masks
    # of DropPath, from the plan drawn once on the host for both devices
    setup = card_vs_cpu_step("O1 ConvNeXt SSL", base + ["distillation.enabled=false",
                                                        "student.drop_path_rate=0.2"],
                             config=DISTILL_CONFIG, n_blocks=None)
    cfg = setup.cfg
    batch = make_synthetic_batch(cfg, 2, seed=4)
    ckpt = os.path.join(O_DIR, "o1_ckpt")
    Checkpointer(ckpt).save(1, setup.state)
    model = build_model_for_eval(cfg, ckpt, device="cuda")
    teacher = setup.meta.teacher["backbone"]
    want = teacher.state_dict()
    check(model.state_dict().keys() == want.keys()
          and all(torch.equal(v, want[k]) for k, v in model.state_dict().items()),
          "[O1] the eval model is not the checkpoint's EMA teacher backbone")
    x = torch.from_numpy(batch["global_crops"]).to("cuda")
    with torch.no_grad():
        got, ref = model(x)["x_norm_clstoken"].float(), teacher(x)["x_norm_clstoken"].float()
    err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-6)
    check(err <= 2.0 ** -5, f"[O1] eval features {err:.3e} of their scale from the teacher's")
    print(f"[O1] build_model_for_eval(ckpt_dir=) on a ConvNeXt-L (1 block a stage) SSL "
          f"checkpoint: the EMA teacher backbone bit for bit, features within {err:.3e} "
          f"of their scale (tol {2.0 ** -5:.3e})")


def startup_split(result: dict) -> dict:
    """A trainer child's start-up by what it does before its first step,
    in seconds: the interpreter and the imports, the config, the CUDA
    context (the kernels' cached libraries loaded), the first batch, the
    meta-arch's module builds and draws, the rest of the set-up, the first
    step (from the set-up's end, by CUDA events); from the child's
    ``startup`` marks and its parent's spawn time."""
    s = result["startup"]
    split = {"imports": s["imported"] - result["spawned"],
             "config": s["config"] - s["imported"],
             "cuda_init": s["cuda_init"] - s["config"],
             "first_batch": s["first_batch"] - s["cuda_init"],
             "draws": s["draws_s"], "setup_rest": s["setup_s"] - s["draws_s"],
             "first_step": s["first_step_s"]}
    split["total"] = sum(split.values())
    return split


def phase_o3(teacher_yaml: str) -> dict:
    """The trainer CLI on O0's recipe with the 1-block ViT-7B-width teacher
    and small heads of N3 (its seeded draw): ConvNeXt-L at full depth, 4
    iterations, a save at 4, ``--dump-weights``; the launches pinned; the
    child's start-up split (``startup_split``); ``build_model_for_eval``
    in this process on the run's checkpoint (its teacher backbone), against
    a model holding the dump's teacher backbone: the same weights and the
    same features, bit for bit."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.models import build_model_for_eval

    run_dir, dump = os.path.join(O_DIR, "run"), os.path.join(O_DIR, "dump.npz")
    base = CONVNEXT_OVERRIDES + N_SMALL_HEADS + [
        "checkpointing.period=4", f"distillation.full_cfg_path={teacher_yaml}"]
    r = run_cli("convnext distill", ["--output-dir", run_dir, "--max-iterations", "4",
                                     "--dump-weights", dump],
                base=base, label="O", log_dir=O_DIR, config=DISTILL_CONFIG, timeout=400)
    want = {k: 4 * v for k, v in convnext_launches(CONVNEXT_NORMS, 1).items()}
    check(r["distillation"] == "in_step" and [s["step"] for s in r["saves"]] == [4]
          and r["launches"] == want and np.isfinite(r["final_loss"]),
          f"[O] O3 run {r} (launches want {want})")
    split = startup_split(r)
    print("[O] O3 the child's start-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in split.items()))
    tcfg = load_config(teacher_yaml, DISTILL_OVERRIDES, n_devices=1)
    model = build_model_for_eval(tcfg, os.path.join(run_dir, "ckpt"), device="cuda")
    dumped = np.load(dump)
    ref = build_model_for_eval(tcfg, device="cuda")
    ref.load_state_dict({k: torch.from_numpy(dumped["teacher/backbone/" + k.replace(".", "/")])
                         for k in ref.state_dict()}, strict=True)
    check(all(torch.equal(v, ref.state_dict()[k]) for k, v in model.state_dict().items()),
          "[O] O3 the eval model's weights are not the dump's teacher backbone")
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(
        (8, 256, 256, 3), np.float32)).to("cuda")
    with torch.no_grad():
        a, b = model(x), ref(x)
    check(all(torch.equal(a[k], b[k]) for k in ("x_norm_clstoken", "x_norm_patchtokens")),
          "[O] O3 the eval model's features differ from the dump's")
    print(f"[O] O3 CLI (ConvNeXt-L full depth <- 1-block ViT-7B-width teacher): 4 iterations, "
          f"launches {r['launches']}; build_model_for_eval(ckpt_dir=) holds the dump's "
          "teacher backbone, the same features bit for bit")
    return {"run": r, "startup": split}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.ops.common import resolve_device

    resolve_device("cuda")
    KERNELS.update(_kernels())
    if sys.argv[1:] == [M2_CHILD]:  # phase M's M2, beside M3
        t0 = time.perf_counter()
        phase_m2()
        print(f"[M] M2 {time.perf_counter() - t0:.1f} s")
        return 0
    if sys.argv[1:2] == [N2_CHILD]:  # phase N's N2, beside N3
        t0 = time.perf_counter()
        phase_n2(sys.argv[2])
        print(f"[N] N2 {time.perf_counter() - t0:.1f} s")
        return 0
    if sys.argv[1:2] == [O1_CHILD]:  # an arm of phase O's O1, beside O3
        t0 = time.perf_counter()
        phase_o1(sys.argv[2], sys.argv[3])
        print(f"[O] O1 {sys.argv[2]} {time.perf_counter() - t0:.1f} s")
        return 0
    cfg = load_config(os.path.join(REPO, "configs", "train", "vitl16_im1k.yaml"))
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[smoke] phase {name}: {seconds[name]:.1f} s")
        return out

    timed("A", phase_a)
    rows = timed("B", phase_b, cfg)
    serve_launches, packs = timed("C", phase_c, cfg)
    timed("D", phase_d, cfg)
    rows.update(timed("B'", phase_b_bwd))
    train_launches, step = timed("E", phase_e)
    timed("F", phase_f)
    g = timed("G", phase_g, step)
    cli = g["uninterrupted"]
    recipe = timed("H", phase_h)
    # before I, which deletes phase G's checkpoint that J4 restores
    serving = timed("J", phase_j, cfg)
    ev = timed("I", phase_i, cfg, g["benchmark"]["step_ms"])
    vitg = timed("K", phase_k)
    lp = timed("L", phase_l)
    gram = timed("M", phase_m)
    distill = timed("N", phase_n)
    cnx = timed("O", phase_o)
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    for key in ("K1", "K4"):
        rows[key]["eval_shapes"] = ev[key]
    rows["K1"]["oracle_shapes"] = serving["k1_oracle"]
    for key in KERNELS:
        rows[key]["vitg_shapes"] = vitg["rows"][key]
        rows[key]["vit7b_shapes"] = gram["M0"][key]
        rows[key]["distill_shapes"] = distill["N0"]["kernels"][key]
        if key in cnx["O0"]["kernels"]:
            rows[key]["convnext_shapes"] = cnx["O0"]["kernels"][key]
    for key in ("K1", "K4"):
        rows[key]["vit7b_eval_shapes"] = cnx["O2"][key]

    table = []
    for key, name, source, replaces in (
        ("K1", "flash_fwd", "dinov3_tpu_torch/csrc/flash_fwd.cu",
         "dinov3_tpu/ops/flash_attention.py:150"),
        ("K2", "flash_bwd_dq", "dinov3_tpu_torch/csrc/flash_bwd_dq.cu",
         "dinov3_tpu/ops/flash_attention.py:336"),
        ("K3", "flash_bwd_dkv", "dinov3_tpu_torch/csrc/flash_bwd_dkv.cu",
         "dinov3_tpu/ops/flash_attention.py:353"),
        ("K4", "layernorm_fwd", "dinov3_tpu_torch/csrc/layernorm.cu",
         "dinov3_tpu/ops/fused_norm.py:121"),
        ("K5", "layernorm_bwd", "dinov3_tpu_torch/csrc/layernorm_bwd.cu",
         "dinov3_tpu/ops/fused_norm.py:140"),
    ):
        r = rows[key]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # the counted runs of the eight paths: 3 serve packs (phase C),
            # 5 training steps (phase E), the trainer CLI's uninterrupted
            # 12-iteration run (phase G at CLI_DEPTH blocks, counted in its
            # own process), 5
            # steps of the recipe as written (phase H1), 4 feature
            # batches of the eval path (phase I1), the serving plane's
            # three measured arms (phase J1), the ViT-g/14 recipe's 11
            # CLI iterations (phase K1, in its own process), the recipe's
            # 5 timed steps in bf16, fp8 and int8 (phase L2), the ViT-7B
            # Gram anchor's 3 timed steps (phase M1) and its CLI's
            # uninterrupted 4 iterations (phase M3, in its own process),
            # the distillation step's 5 timed steps with its 40-block
            # teacher (N0), the teacher engine's first packs and the 3
            # serve-arm steps (N1), and the distillation CLI's
            # uninterrupted 4 iterations (N3, in its own process), the
            # ConvNeXt-L distillation step's 5 timed steps (O0), the eval
            # batches of ConvNeXt-L and the 40-block ViT-7B (O2) and the
            # ConvNeXt CLI's 4 iterations (O3, in its own process)
            "launches": (serve_launches[key] + train_launches[key] + cli["launches"][key]
                         + recipe["launches"][key] + ev["launches"][key]
                         + serving["launches"][key] + vitg["cli"]["launches"][key]
                         + sum(lp["L2"][arm]["launches"][key] for arm in lp["L2"])
                         + gram["M1"]["launches"][key]
                         + gram["M3"]["uninterrupted"]["launches"][key]
                         + distill["N0"]["launches"][key]
                         + distill["N1"]["pack_launches"][key]
                         + distill["N1"]["step_launches"][key]
                         + distill["N3"]["uninterrupted"]["launches"][key]
                         + cnx["O0"]["launches"][key]
                         + cnx["O2"]["convnext"]["launches"][key]
                         + cnx["O2"]["vit7b"]["launches"][key]
                         + cnx["O3"]["run"]["launches"][key]),
            "launches_per_convnext_distill_step": cnx["O0"]["per_step"][key],
            "launches_per_distill_step": distill["N0"]["per_step"][key],
            "launches_per_distill_serve_step": distill["N1"]["per_step"][key],
            "launches_per_teacher_pack": distill["N1"]["per_pack"][key],
            "launches_per_vit7b_gram_step": gram["M1"]["per_step"][key],
            "launches_per_recipe_step_fp8": lp["L2"]["fp8"]["per_step"][key],
            "launches_per_recipe_step_int8": lp["L2"]["int8"]["per_step"][key],
            "launches_serving_plane": serving["launches"][key],
            "launches_per_serve_pack": serve_launches[key] / packs,
            "launches_per_train_step": train_launches[key] / 5,
            "launches_per_cli_iteration": cli["launches"][key] / cli["iterations"],
            "launches_per_recipe_step": recipe["per_step"][key],
            "launches_per_eval_batch": ev["launches"][key] / ev["batches"],
            "launches_per_vitg_step": vitg["cli"]["launches"][key] / VITG_ITERS,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("cold_ms", "visited_share", "walked_share", "train_shapes",
                                 "eval_shapes", "oracle_shapes", "vitg_shapes",
                                 "vit7b_shapes", "distill_shapes", "convnext_shapes",
                                 "vit7b_eval_shapes") if k in r},
        })
    print(f"[smoke] train step {step['ms']:.1f} ms, "
          f"{TRAIN_B / step['ms'] * 1e3:.2f} img/s, peak {step['peak_gib']:.2f} GiB; "
          f"the recipe as written (B={recipe['B']}) {recipe['median_ms']:.1f} ms, "
          f"{recipe['B'] / recipe['median_ms'] * 1e3:.2f} img/s, peak {recipe['peak_gib']:.2f} GiB; "
          f"eval extraction {ev['img_s']:.1f} img/s at B={EVAL_B}, peak {ev['peak_gib']:.2f} GiB; "
          f"k-NN at ImageNet-1k size {ev['i3']['knn_s']:.2f} s, a sweep epoch "
          f"{ev['i3']['sweep_epoch_s']:.2f} s; the ViT-g/14 recipe (B={VITG_B}) "
          f"{vitg['cli']['ms_per_step']:.1f} ms a step, {vitg['cli']['img_per_sec']:.2f} img/s, "
          f"peak {vitg['cli']['peak_memory_gib']:.2f} GiB; the recipe in fp8 "
          f"{lp['L2']['fp8']['median_ms']:.1f} ms, int8 {lp['L2']['int8']['median_ms']:.1f} ms "
          f"(bf16 {lp['L2']['bf16']['median_ms']:.1f} ms); the ViT-7B/16 Gram anchor "
          f"(B={GRAM_B}, {GRAM_DEPTH} blocks) {gram['M1']['median_ms']:.1f} ms a step, "
          f"{GRAM_B / gram['M1']['median_ms'] * 1e3:.2f} img/s, peak "
          f"{gram['M1']['peak_gib']:.2f} GiB; ViT-L/16 distilled from the 40-block "
          f"ViT-7B/16 (B={DISTILL_B}) {distill['N0']['median_ms']:.1f} ms a step, "
          f"{DISTILL_B / distill['N0']['median_ms'] * 1e3:.2f} img/s, peak "
          f"{distill['N0']['peak_gib']:.2f} GiB, set-up {distill['N0']['setup_s']:.1f} s; "
          f"the teacher engine {distill['N1']['miss_img_s']:.1f} img/s at 256 px; "
          f"ConvNeXt-L/16 distilled from the 40-block ViT-7B/16 (B={DISTILL_B}) "
          f"{cnx['O0']['median_ms']:.1f} ms a step, "
          f"{DISTILL_B / cnx['O0']['median_ms'] * 1e3:.2f} img/s, peak "
          f"{cnx['O0']['peak_gib']:.2f} GiB; eval extraction at B={EVAL_B}, {EVAL_PX} px: "
          f"ConvNeXt-L {cnx['O2']['convnext']['img_s']:.1f} img/s, ViT-7B/16 "
          f"{cnx['O2']['vit7b']['img_s']:.1f} img/s")
    print(json.dumps({"kernels": table}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
