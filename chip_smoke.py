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
   ViT-L/16 full width and depth, B=32, synthetic data, each run a child
   process with a time limit: uninterrupted to 4 iterations; to 2; then,
   with a torn ``tmp.3/`` and an unfinalized ``3/`` planted, resumed in a
   new process to 4, its losses compared with the uninterrupted run's
   (``--ref-losses``) and its final teacher with that run's; before them a
   longer ``--benchmark`` run; ``--self-check``; and 2 steps of the image-folder
   pipeline on texture images. Each child's K1-K5 launches are checked
   against ``STEP_LAUNCHES`` per step; the checkpoints are deleted after.

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
   over the same 256 mixed_ragged requests after a disjoint warm-up draw
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

Prints the kernel table as one JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; without a card it exits non-zero
before doing anything.
"""

from __future__ import annotations

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


def profile_step(setup, state, host_batch, label: str = "E") -> dict:
    """Device time by kernel class over one training step whose batch is
    put on the card (``put_batch``, pinned) inside the recorded window,
    from torch.profiler device events (the tracer warmed up first); the
    wall time is that of the recorded step, tracer included. Returns the
    wall and busy ms and the ms by class ({} without device events)."""
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
               ("K5 layernorm_bwd", ("layernorm_bwd",)))
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


def card_vs_cpu_step(label: str, overrides: list) -> None:
    """The phase-F pattern under ``overrides``: a 2-block ViT-L-width model
    (4096 prototypes, B=4, LayerScale 1) takes one step on the card and
    one on the CPU from the same weights, batch and drop-path plans (one a
    microbatch under ``optim.accum_steps``); loss terms, gradient norms
    and the updated student compared."""
    import torch

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.rng import packed_pass_plan, step_generator
    from dinov3_tpu_torch.train import build_train_setup
    from dinov3_tpu_torch.train.train_step import packed_layout, split_microbatches

    B = 4
    cfg = load_config(
        os.path.join(REPO, "configs", "train", "vitl16_im1k.yaml"),
        [f"train.batch_size_per_device={B}", "student.layerscale=1.0",
         "dino.head_n_prototypes=4096", "ibot.head_n_prototypes=4096", *overrides],
        n_devices=1)
    batch = make_synthetic_batch(cfg, B, seed=1)
    it = cfg.optim.warmup_epochs * cfg.train.OFFICIAL_EPOCH_LENGTH
    accum = int(cfg.optim.accum_steps)
    plans = [packed_pass_plan(step_generator(0, it, None if accum == 1 else j), 2,
                              packed_layout(cfg, mb).rows_total, cfg.student.drop_path_rate)
             for j, mb in enumerate(split_microbatches(batch, accum))]
    check(all(plans), f"[{label}] no drop-path plan")
    results = {}
    for dev in ("cuda", "cpu"):
        setup = build_train_setup(cfg, batch, device=dev, seed=2, n_blocks=2)
        state = setup.state
        state.step = state.opt_state.count = it
        before = {n: p.detach().cpu().clone()
                  for n, p in setup.meta.student.named_parameters()}
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, batch, setup.scalars(it),
                                 plan=plans if accum > 1 else plans[0])
        print(f"[{label}] one step on {dev}: {(time.perf_counter() - t0) * 1e3:.1f} ms; "
              + ", ".join(f"{k} {m[k]:.4f}" for k in LOSS_KEYS))
        after = {n: p.detach().cpu() for n, p in setup.meta.student.named_parameters()}
        results[dev] = (m, before, after)
    (mc, before, after_c), (mp, before_p, after_p) = results["cuda"], results["cpu"]
    check(all(torch.equal(before[n], before_p[n]) for n in before),
          "card and CPU started from other weights")
    # losses and gradient norms: 2^-5 relative. Both sides compute in bf16,
    # with matmul sums in other orders, and K1-K3 round the attention
    # probabilities and dS to bf16 where the plain versions keep fp32
    worst = 0.0
    for k in LOSS_KEYS + tuple(k for k in mc if k.startswith("grad_norm/")):
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
    close = total = 0
    for n in before:
        d_c, d_p = after_c[n] - before[n], after_p[n] - before[n]
        err = (d_c - d_p).abs()
        step = d_p.abs().max().item()
        check(err.max().item() <= 2 * step + 1e-6,
              f"[{label}] {n}: update differs by {err.max().item():.3e} > 2 x {step:.3e}")
        moved = d_p.abs() > 0.1 * step
        close += int((err[moved] <= 0.1 * d_p.abs()[moved]).sum())
        total += int(moved.sum())
    print(f"[{label}] updated student: {close / total:.4f} of the moved entries within "
          f"a tenth of their step (lr {lr:.3e})")
    check(close >= 0.9 * total, f"[{label}] updated students disagree")


# ---------------------------------------------------------------- phase G

G_DIR = os.path.join(REPO, "build", "phase_g")
CLI_CONFIG = os.path.join("configs", "train", "vitl16_im1k.yaml")
# the trainer's command of the ViT-L/16 slice: B=32, materialized targets,
# synthetic data, a save every 2 iterations
CLI_OVERRIDES = TRAIN_OVERRIDES + ["checkpointing.period=2"]


def run_cli(name: str, args: list, overrides=(), timeout: int = 420,
            base=CLI_OVERRIDES, label: str = "G", log_dir: str = G_DIR) -> dict:
    """One run of ``python -m dinov3_tpu_torch.train.train`` as a child
    process with a time limit (the ``base`` overrides, then
    ``overrides``); its output goes to ``<log_dir>/<name>.log`` and its
    last line is its result. Raises on a non-zero exit."""
    cmd = [sys.executable, "-m", "dinov3_tpu_torch.train.train",
           "--config-file", CLI_CONFIG, *args, *base, *overrides]
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
    result["wall_s"] = wall
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
    want = {k: v * steps for k, v in STEP_LAUNCHES.items()}
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


def plant_torn_saves(ckpt_dir: str) -> None:
    """A save cut before its rename (``tmp.3/`` holding a partial payload)
    and one cut before its marker (``3/`` with a payload, no FINALIZED)."""
    for d in ("tmp.3", "3"):
        os.makedirs(os.path.join(ckpt_dir, d))
        with open(os.path.join(ckpt_dir, d, "state.pt"), "wb") as f:
            f.write(b"PK\x03\x04 torn payload")


def phase_g(step: dict) -> dict:
    """The trainer CLI at ViT-L/16, B=32 on the card (module docstring)."""
    import torch

    from dinov3_tpu_torch.configs import load_config

    gc.collect()
    torch.cuda.empty_cache()  # the children need the card's memory
    shutil.rmtree(G_DIR, ignore_errors=True)
    os.makedirs(G_DIR)
    try:
        return _phase_g(step, load_config(os.path.join(REPO, CLI_CONFIG),
                                          TRAIN_OVERRIDES, n_devices=1))
    finally:
        shutil.rmtree(G_DIR, ignore_errors=True)


def _phase_g(step: dict, cfg) -> dict:
    from dinov3_tpu_torch.train.schedules import build_schedules

    # first, before the runs that write checkpoints: 12 iterations, the
    # last 8 timed, one save at the end (after the last mark)
    bench = run_cli("benchmark", ["--output-dir", os.path.join(G_DIR, "b"),
                                  "--max-iterations", "12", "--benchmark", "8"],
                    ["checkpointing.period=100"])
    check_launches("benchmark", bench, 12)
    shutil.rmtree(os.path.join(G_DIR, "b"))
    a_dir, r_dir = os.path.join(G_DIR, "a"), os.path.join(G_DIR, "r")
    a_losses = os.path.join(G_DIR, "a.jsonl")
    a = run_cli("uninterrupted", ["--output-dir", a_dir, "--max-iterations", "4",
                                  "--benchmark", "2", "--record-losses", a_losses])
    check_launches("uninterrupted", a, 4)
    check([s["step"] for s in a["saves"]] == [2, 4], f"[G] saves {a['saves']}")
    losses = read_losses(a_losses)
    check(sorted(losses) == [0, 1, 2, 3] and all(
        np.isfinite(v) for r in losses.values() for k, v in r.items() if k != "iteration"),
        f"[G] uninterrupted losses {losses}")
    r1 = run_cli("to 2", ["--output-dir", r_dir, "--max-iterations", "2"])
    check_launches("to 2", r1, 2)
    plant_torn_saves(os.path.join(r_dir, "ckpt"))
    r_losses = os.path.join(G_DIR, "r.jsonl")
    r2 = run_cli("resumed to 4", ["--output-dir", r_dir, "--max-iterations", "4",
                                  "--record-losses", r_losses, "--ref-losses", a_losses])
    check(r2["start_iteration"] == 2 and r2["iterations"] == 4,
          f"[G] resumed at {r2['start_iteration']}, not at 2 past the torn saves")
    check_launches("resumed to 4", r2, 2)
    # resumed losses against the uninterrupted run's: the CLI's own
    # comparator, |err| <= 1e-4 + 1e-3 |recorded| (index_add on the card
    # sums with atomics, so the runs need not be bitwise equal)
    resumed = read_losses(r_losses)
    diffs = [abs(resumed[i][k] - losses[i][k]) for i in (2, 3) for k in resumed[i]
             if k != "iteration"]
    print(f"[G] resumed vs uninterrupted losses at iterations 2-3: largest "
          f"|difference| {max(diffs):.3e}, bitwise {max(diffs) == 0.0}; "
          f"{r2['loss_comparison']}")
    check(sorted(resumed) == [2, 3] and r2["loss_divergences"] == 0,
          f"[G] resumed losses diverge: {r2['loss_comparison']}")
    # the final teacher: from the same start the EMA moves each entry by
    # (1 - m) of the student's update; an Adam update whose gradient is at
    # noise level can go either way (|update| <= 2 lr in these first
    # steps), so the runs may differ by sum (1 - m) 4 lr, plus 1e-5 of
    # each tensor's largest magnitude
    sched = build_schedules(cfg)
    drift = sum((1 - float(sched.momentum[i])) * 4 * float(sched.lr[i]) for i in range(4))
    ta, tr = teacher_of(a_dir, 4), teacher_of(r_dir, 4)
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
    # the uninterrupted run's step-4 checkpoint is phase I's to evaluate
    shutil.rmtree(I_DIR, ignore_errors=True)
    os.makedirs(I_CKPT)
    os.rename(os.path.join(a_dir, "ckpt", "4"), os.path.join(I_CKPT, "4"))
    shutil.rmtree(a_dir)
    shutil.rmtree(r_dir)

    sc = run_cli("self-check", ["--output-dir", os.path.join(G_DIR, "s"), "--self-check"])
    failed = [k for k, v in sc.items() if k.startswith("check/") and not v]
    print(f"[G] self-check at full width: {sum(k.startswith('check/') for k in sc)} "
          f"checks, failures {failed}")
    check(sc["self_check_failures"] == 0 and not failed, f"[G] self-check failed: {failed}")
    check_launches("self-check", sc, 2)

    # the image-folder pipeline: 2 steps on texture images (PIL on the host)
    from dinov3_tpu_torch.data.textures import materialize_textures

    t0 = time.perf_counter()
    train_dir, _ = materialize_textures(os.path.join(G_DIR, "textures"),
                                        n_train_per_class=8, n_val_per_class=0,
                                        px=256, seed=0)
    print(f"[G] 96 texture images of 256 px written in {time.perf_counter() - t0:.1f} s")
    folder = run_cli("folder", ["--output-dir", os.path.join(G_DIR, "f"),
                                "--max-iterations", "2"],
                     ["data.backend=folder", f"train.dataset_path=Folder:root={train_dir}",
                      "train.num_workers=8"])
    check_launches("folder", folder, 2)
    check(np.isfinite(folder["final_loss"]), f"[G] folder run loss {folder['final_loss']}")

    print(f"[G] CLI --benchmark: {a['img_per_sec']:.2f} img/s ({a['ms_per_step']:.1f} ms a "
          f"step over 2 steps), {bench['img_per_sec']:.2f} img/s ({bench['ms_per_step']:.1f} "
          f"ms over 8 steps); phase E step_fn: {TRAIN_B / step['median_ms'] * 1e3:.2f} img/s "
          f"at its median {step['median_ms']:.1f} ms; CLI / phase E "
          f"{bench['ms_per_step'] / step['median_ms']:.4f}")
    return {"uninterrupted": a, "benchmark": bench, "resumed": r2}


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
               profile: bool = False) -> dict:
    """The recipe at full width and depth under ``extra``, through
    ``build_train_setup`` + ``step_fn``: step 0 as the warm-up (its loss
    terms kept for the comparisons), then ``steps`` timed steps with every
    loss finite and, where ``launches`` is given, K1-K5 launches pinned
    per step. Returns the step-0 losses, the times, the peak memory and
    the launches; optionally one profiled step and the step's host waits."""
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
           "per_step": per_step, "B": B, "state": state}
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
    """Operations of one image through the ViT forward: 24 D^2 a token a
    block (qkv, proj and the 4x MLP, two operations a MAC), attention
    4 N^2 d a head a block, the patch embedding."""
    D, L, H = model.embed_dim, model.n_blocks, model.num_heads
    p = model.patch_size
    blocks = L * (24 * n_tokens * D * D + 4 * n_tokens ** 2 * (D // H) * H)
    return blocks + 2 * (n_tokens - model.n_prefix) * p * p * model.in_chans * D


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
    from dinov3_tpu_torch.evals import extract_features, make_feature_fn
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
    n_img = n_batches * EVAL_B
    print(f"[I1] host pipeline (8 threads: synthetic 256 px images, resize, centre crop "
          f"224, normalize, collate): {(n_batches + 1) * EVAL_B} images in {host_s:.2f} s, "
          f"{(n_batches + 1) * EVAL_B / host_s:.1f} img/s")
    check(batches[0]["image"].shape == (EVAL_B, EVAL_PX, EVAL_PX, 3), "[I1] batch shape")
    warm, _ = extract_features(model, iter(batches[:1]))  # library handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    feats, labels = extract_features(model, iter(batches[1:]))
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = forward_flops(model, 1 + (EVAL_PX // 16) ** 2)
    img_s = n_img / wall
    cap = BF16_TC_FLOP_S / flops
    print(f"[I1] extract_features: {n_img} images in {wall * 1e3:.1f} ms (host batches in "
          f"memory, pinned copies, one read-back a batch, synchronized): {img_s:.1f} img/s; "
          f"{flops / 1e9:.1f} GFLOP an image caps the card at {cap:.0f} img/s, share "
          f"{img_s / cap:.4f}; peak memory {peak:.2f} GiB; launches {launches}")
    check(feats.shape == (n_img, 1024) and feats.dtype == np.float32
          and np.isfinite(feats).all() and labels.shape == (n_img,), "[I1] bad features")
    want = {k: v * n_batches for k, v in EVAL_LAUNCHES.items()}
    check(launches == want, f"[I1] launches {launches} != {want}")
    # the same images as one more batch: the first batch's features again
    again, _ = extract_features(model, iter(batches[:1]))
    check(np.array_equal(warm, again), "[I1] two extractions of one batch differ")
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
    return {"launches": launches, "batches": n_batches, "img_s": img_s, "peak_gib": peak,
            "K1": k1, "K4": k4}


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
           "n_classes=10", "train.num_workers=8"]
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
    model = build_model_for_eval(cfg, I_CKPT, device="cuda")
    want = teacher_of(I_DIR, 4)
    got = model.state_dict()
    bad = [k for k, v in got.items() if not torch.equal(v.cpu(), want[f"backbone.{k}"])]
    check(not bad and len(got) == sum(k.startswith("backbone.") for k in want),
          f"[I4] restored teacher differs from the checkpoint's: {bad[:5]}")
    print(f"[I4] build_model_for_eval: the EMA teacher backbone of step 4, {len(got)} "
          f"tensors, bitwise the checkpoint's")
    del model, want, got


def phase_i5(g_step_ms: list) -> None:
    """Evals inside a trainer CLI run at ViT-L/16, B=32: 3 iterations, an
    eval after the second (inside a --benchmark interval), one save."""
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
    want = {k: 3 * v + I5_FEATURE_BATCHES * EVAL_LAUNCHES[k] for k, v in STEP_LAUNCHES.items()}
    check(result["launches"] == want, f"[I5] launches {result['launches']} != {want}")
    check(np.isfinite(result["final_loss"]), f"[I5] loss {result['final_loss']}")
    lo, hi = min(g_step_ms), max(g_step_ms)
    check(all(0.9 * lo <= t <= 1.1 * hi for t in result["step_ms"]),
          f"[I5] step times {result['step_ms']} outside phase G's band "
          f"[0.9 x {lo:.1f}, 1.1 x {hi:.1f}] ms")
    print(f"[I5] step times within phase G's band ({lo:.1f}-{hi:.1f} ms, 10 % each way)")


# ---------------------------------------------------------------- phase J

J_DIR = os.path.join(REPO, "build", "phase_j")
# measured requests of each serving-plane draw (and as many warm-up ones)
J_N = 256
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


# ---------------------------------------------------------------- main

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
    cfg = load_config(os.path.join(REPO, "configs", "train", "vitl16_im1k.yaml"))
    t_start = time.perf_counter()
    phase_a()
    rows = phase_b(cfg)
    serve_launches, packs = phase_c(cfg)
    phase_d(cfg)
    rows.update(phase_b_bwd())
    train_launches, step = phase_e()
    phase_f()
    g = phase_g(step)
    cli = g["uninterrupted"]
    recipe = phase_h()
    # before I, which deletes phase G's checkpoint that J4 restores
    serving = phase_j(cfg)
    ev = phase_i(cfg, g["benchmark"]["step_ms"])
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f} s")
    for key in ("K1", "K4"):
        rows[key]["eval_shapes"] = ev[key]
    rows["K1"]["oracle_shapes"] = serving["k1_oracle"]

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
            # the counted runs of the six paths: 3 serve packs (phase C),
            # 5 training steps (phase E), the trainer CLI's uninterrupted
            # 4-iteration run (phase G, counted in its own process), 5
            # steps of the recipe as written (phase H1), 4 feature
            # batches of the eval path (phase I1) and the serving plane's
            # three measured arms (phase J1)
            "launches": (serve_launches[key] + train_launches[key] + cli["launches"][key]
                         + recipe["launches"][key] + ev["launches"][key]
                         + serving["launches"][key]),
            "launches_serving_plane": serving["launches"][key],
            "launches_per_serve_pack": serve_launches[key] / packs,
            "launches_per_train_step": train_launches[key] / 5,
            "launches_per_cli_iteration": cli["launches"][key] / 4,
            "launches_per_recipe_step": recipe["per_step"][key],
            "launches_per_eval_batch": ev["launches"][key] / ev["batches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("cold_ms", "visited_share", "walked_share", "train_shapes",
                                 "eval_shapes", "oracle_shapes") if k in r},
        })
    print(f"[smoke] train step {step['ms']:.1f} ms, "
          f"{TRAIN_B / step['ms'] * 1e3:.2f} img/s, peak {step['peak_gib']:.2f} GiB; "
          f"the recipe as written (B={recipe['B']}) {recipe['median_ms']:.1f} ms, "
          f"{recipe['B'] / recipe['median_ms'] * 1e3:.2f} img/s, peak {recipe['peak_gib']:.2f} GiB; "
          f"eval extraction {ev['img_s']:.1f} img/s at B={EVAL_B}, peak {ev['peak_gib']:.2f} GiB; "
          f"k-NN at ImageNet-1k size {ev['i3']['knn_s']:.2f} s, a sweep epoch "
          f"{ev['i3']['sweep_epoch_s']:.2f} s")
    print(json.dumps({"kernels": table}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
