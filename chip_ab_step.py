#!/usr/bin/env python3
"""Times the port's training step and its backward kernels K2, K3 and K5
from several checkouts of this repository, in turns, on one NVIDIA card.

    python3 chip_ab_step.py DIR_A DIR_B [DIR ...]

Each DIR is the root of a checkout (for example the parent commit unpacked
with ``git archive`` into the git-ignored ``build/``, and ``.`` for this
one). The checkouts run in the order given, each in a process of its own
that imports the port from that checkout and builds its kernels there; give
them in turns (A B B A) to see the drift within the call. Each run times,
with that checkout's own wrappers:
- K2 (flash-attention dQ) and K3 (dK/dV) at a student block's attention,
  [81 x 16, 197, 64] bf16 with the packed ids, and K5 (LayerNorm
  backward) at a student block's norm, [15957, 1024] bf16 with an fp32
  scale: device time per call (``chip_smoke.cuda_ms``);
- the SSL training step at ViT-L/16 full width and depth, B = 32
  (``chip_smoke.py`` phase E's configuration and seeds): a warm-up step,
  then 5 steps, host clock around each, synchronized; median and mean;
- where the checkout has the trainer CLI (``dinov3_tpu_torch/train/
  train.py``), the same configuration through it, in a child process:
  12 iterations of synthetic data, the last 8 timed by ``--benchmark``
  (its steady-state ms a step, the batch made on its data thread).
Prints one JSON line a run, then the card's name and power limit. Exits
non-zero without a card or if a run fails.
"""

from __future__ import annotations

import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

STEPS = 5


def one_run(tree: str) -> dict:
    """The measurements of one checkout, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as smoke
    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.data import make_synthetic_batch
    from dinov3_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from dinov3_tpu_torch.ops.fused_norm import layernorm_bwd
    from dinov3_tpu_torch.train import build_train_setup, put_batch

    if not smoke.__file__.startswith(tree):
        raise RuntimeError(f"imported {smoke.__file__}, not the checkout at {tree}")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    seg = torch.from_numpy(smoke.train_attention_seg()).to(dev)
    R, N = seg.shape
    H, D = 16, 64
    qkv = torch.randn(R, N, 3 * H * D, generator=g).to(dev, torch.bfloat16)
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].reshape(R, N, H, D) for i in range(3))
    q, k = q.contiguous(), k.contiguous()
    do = torch.randn(q.shape, generator=g).to(dev, torch.bfloat16)
    fwd = flash_fwd(q, k, v, seg)
    out, lse = fwd[:2]
    # a checkout whose forward hands the backward its tile schedule passes
    # it on to each kernel whose wrapper takes one, as its autograd
    # Function does
    extra = fwd[2:]
    extra_dq = extra if "schedule" in inspect.signature(flash_bwd_dq).parameters else ()
    _, delta = flash_bwd_dq(q, k, v, out, lse, do, seg, *extra_dq)
    k2_ms = smoke.cuda_ms(lambda: flash_bwd_dq(q, k, v, out, lse, do, seg, *extra_dq), 20)
    k3_ms = smoke.cuda_ms(lambda: flash_bwd_dkv(q, k, v, lse, delta, do, seg, *extra), 20)
    x = (torch.randn(81 * 197, 1024, generator=g) * 3 + 1).to(dev, torch.bfloat16)
    dy = torch.randn(x.shape, generator=g).to(dev, torch.bfloat16)
    s = (torch.randn(1024, generator=g) * 0.5 + 1).to(dev)
    k5_ms = smoke.cuda_ms(lambda: layernorm_bwd(x, s, dy), 50)
    del qkv, q, k, v, do, out, lse, delta, fwd, extra, extra_dq, x, dy

    cfg = load_config(os.path.join(tree, "configs", "train", "vitl16_im1k.yaml"),
                      smoke.TRAIN_OVERRIDES, n_devices=1)
    batch = make_synthetic_batch(cfg, smoke.TRAIN_B, seed=0)
    setup = build_train_setup(cfg, batch, device="cuda", seed=0)
    dbatch = put_batch(batch, "cuda")
    state = setup.state
    state, _ = setup.step_fn(state, dbatch, setup.scalars(state.step))  # warm-up
    times = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = setup.step_fn(state, dbatch, setup.scalars(state.step))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(m["total_loss"]):
            raise RuntimeError(f"{tree}: non-finite loss {m}")
    result = {"tree": tree, "k2_ms": k2_ms, "k3_ms": k3_ms, "k5_ms": k5_ms,
              "step_median_ms": float(np.median(times)),
              "step_mean_ms": float(np.mean(times)), "steps_ms": times,
              "card": torch.cuda.get_device_name(0)}
    if os.path.exists(os.path.join(tree, "dinov3_tpu_torch", "train", "train.py")):
        del setup, state, dbatch
        torch.cuda.empty_cache()  # the child needs the card's memory
        result.update(cli_run(tree))
    return result


def cli_run(tree: str) -> dict:
    """The trainer CLI of ``tree`` at the step's configuration, in a child
    process: 12 iterations, the last 8 timed (``--benchmark``), one save at
    the end into a scratch directory under the checkout's ``build/``."""
    import chip_smoke as smoke

    os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="ab_cli_", dir=os.path.join(tree, "build"))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "dinov3_tpu_torch.train.train", "--config-file",
             os.path.join("configs", "train", "vitl16_im1k.yaml"), "--output-dir", out,
             "--max-iterations", "12", "--benchmark", "8", *smoke.TRAIN_OVERRIDES,
             "checkpointing.period=100"],
            cwd=tree, capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: trainer failed\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"cli_ms_per_step": cli["ms_per_step"], "cli_steps_ms": cli["step_ms"]}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_step: needs an NVIDIA card", file=sys.stderr)
        return 1
    if argv[:1] == ["--one"]:
        print(json.dumps(one_run(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                             capture_output=True, text=True)
        lines = res.stdout.strip().splitlines()
        if res.returncode != 0 or not lines:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
