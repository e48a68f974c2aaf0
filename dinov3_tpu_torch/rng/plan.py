"""The drop-path plan of the crop-packed student pass (``dinov3_tpu/rng/plan.py``).

One draw per step gives every block's randomness: for subset drop path,
``{"idx": [L, 2, keep]}`` kept-row indices per (layer, branch), each slice
sorted and unique, from one uniform draw and one batched argsort (a random
permutation per consumer, as ``jax.random.permutation`` builds it); for
mask mode ``{"keep": [L, 2, B]}`` Bernoulli keep bits. The rows are the
packed pass's 2B + P mixed rows, so a dropped packed row drops its k local
crops together, as in the reference.

The generator is an explicit ``torch.Generator`` seeded from
``(seed, iteration)`` (with accumulation, ``(seed, iteration,
microbatch)``), so a step's draws are a pure function of them. Its
numbers are not JAX's: tests hand the JAX plan across as numpy instead.
"""

from __future__ import annotations

import numpy as np
import torch

from dinov3_tpu_torch.ops.drop_path import resolve_drop_path, subset_keep_count


def step_generator(seed: int, iteration: int,
                   microbatch: int | None = None) -> torch.Generator:
    """A CPU generator keyed by (seed, iteration), or by (seed, iteration,
    microbatch) for microbatch j of an accumulated step (the reference's
    ``fold_in(fold_in(key, iteration), j)``)."""
    key = [int(seed), int(iteration)] + ([] if microbatch is None else [int(microbatch)])
    state = np.random.SeedSequence(key).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def subset_plan(generator: torch.Generator, n_blocks: int, batch: int,
                rate: float) -> torch.Tensor:
    """[L, 2, keep] int64 kept-row indices, each slice sorted and unique."""
    keep = subset_keep_count(batch, rate)
    u = torch.rand((n_blocks, 2, batch), generator=generator)
    kept = torch.argsort(u, dim=-1)[..., :keep]
    return torch.sort(kept, dim=-1).values


def mask_plan(generator: torch.Generator, n_blocks: int, batch: int,
              rate: float) -> torch.Tensor:
    """[L, 2, B] bool keep bits, each True with probability 1 - rate."""
    return torch.rand((n_blocks, 2, batch), generator=generator) < 1.0 - rate


def packed_pass_plan(generator: torch.Generator, n_blocks: int, rows: int,
                     rate: float, mode: str = "subset") -> dict:
    """The packed pass's plan over ``rows`` = 2B + P rows: {} without
    drop path, else {"drop_path": {"idx": ...}} or {"drop_path":
    {"keep": ...}} (the mode ``resolve_drop_path`` decides)."""
    if rate <= 0.0:
        return {}
    if resolve_drop_path(rows, rate, mode) == "subset":
        return {"drop_path": {"idx": subset_plan(generator, n_blocks, rows, rate)}}
    return {"drop_path": {"keep": mask_plan(generator, n_blocks, rows, rate)}}


def plan_to_device(plan: dict | None, device) -> dict:
    """A plan (torch or numpy arrays, e.g. the JAX plan's) on ``device``:
    indices as int64, keep bits as bool."""
    out = {}
    for key, value in (plan or {}).items():
        if isinstance(value, dict):
            out[key] = plan_to_device(value, device)
        else:
            t = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value)
                                else value)
            # non_blocking: from pageable memory the copy is staged at
            # once, so the host does not wait for the queued work
            out[key] = t.to(device, torch.bool if key == "keep" else torch.int64,
                            non_blocking=True)
    return out


def plan_layer_slice(plan: dict | None, i: int) -> dict | None:
    """Block i's slice of a pass plan's stacked drop-path arrays."""
    if not plan or "drop_path" not in plan:
        return None
    return {k: v[i] for k, v in plan["drop_path"].items()}
