"""The student passes' randomness plans (``dinov3_tpu/rng/plan.py``).

A pass plan holds every draw one student forward consumes:
``{"drop_path": {"idx": [L, 2, keep]}}`` kept-row indices per (layer,
branch) for subset drop path, each slice sorted and unique, or
``{"drop_path": {"keep": [L, 2, B]}}`` Bernoulli keep bits in mask mode;
and with RoPE coordinate augmentation ``{"rope": factors}``
(``ops/rope.py rope_aug_values``). The crop-packed pass draws its drop
path over its 2B + P mixed rows (a dropped packed row drops its k local
crops together, as in the reference) and carries the factors of both crop
kinds, ``{"rope": {"global": ..., "local": ...}}``; the two-pass student
(``model.crop_packing=false``) takes ``{"global": plan, "local": plan}``.

Two derivations, as in the reference (``rng.plan``):
- the step plan (``step_plan``, the default): one generator keyed by
  ``(seed, iteration)`` (with accumulation ``(seed, iteration,
  microbatch)``) makes every draw of the step, the drop path of each pass
  from one uniform draw and one batched argsort (a random permutation per
  consumer, as ``jax.random.permutation`` builds it), the RoPE factors of
  each crop kind from one draw of five uniforms;
- ``rng.plan=false`` (``fold_in_plan``): a generator for each pass and
  block, keyed by ``(seed, iteration[, microbatch], pass, block)``, draws
  that block's kept rows as a permutation for each branch, and one for
  each pass draws the RoPE factors in three draws, as the reference's
  per-block ``fold_in`` keys do.

A ConvNeXt student (two passes, no plan engine, as in the reference)
takes per-block keep bits of its per-sample mask (``convnext_plan``).

The numbers are not JAX's (threefry is not ported): tests hand the JAX
plan across as numpy instead, and hold the two derivations' statistics to
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from dinov3_tpu_torch.ops.drop_path import (
    mask_keep_bits,
    resolve_drop_path,
    subset_keep_count,
)
from dinov3_tpu_torch.ops.rope import augment_coords, rope_aug_values

CROP_KINDS = ("global", "local")
# the fold-in tags of the passes (``fold_in_plan``)
PASS_TAGS = {"global": 0, "local": 1, "packed": 2}


def key_generator(*key: int) -> torch.Generator:
    """A CPU generator seeded from the non-negative ints of ``key``."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(2)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def step_generator(seed: int, iteration: int,
                   microbatch: int | None = None) -> torch.Generator:
    """A CPU generator keyed by (seed, iteration), or by (seed, iteration,
    microbatch) for microbatch j of an accumulated step (the reference's
    ``fold_in(fold_in(key, iteration), j)``)."""
    return key_generator(seed, iteration,
                         *(() if microbatch is None else (microbatch,)))


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
    """One pass's drop-path plan over ``rows`` rows (the packed pass's
    2B + P, or a two-pass pass's crops): {} without drop path, else
    {"drop_path": {"idx": ...}} or {"drop_path": {"keep": ...}} (the mode
    ``resolve_drop_path`` decides)."""
    if rate <= 0.0:
        return {}
    if resolve_drop_path(rows, rate, mode) == "subset":
        return {"drop_path": {"idx": subset_plan(generator, n_blocks, rows, rate)}}
    return {"drop_path": {"keep": mask_plan(generator, n_blocks, rows, rate)}}


def rope_plan(generator: torch.Generator, rope_aug: tuple) -> dict:
    """The RoPE factors of one crop kind from one draw of five uniforms;
    ``rope_aug`` = (shift, jitter, rescale)."""
    return rope_aug_values(torch.rand(5, generator=generator), *rope_aug)


def step_plan(generator: torch.Generator, *, n_blocks: int, rows: dict,
              rate: float, mode: str = "subset",
              rope_aug: tuple | None = None) -> dict:
    """The step's plan from one generator. ``rows``: {"packed": 2B + P}
    for the packed pass, whose plan it returns, or {"global": 2B,
    "local": n_l*B} for the two passes, returned as {"global": plan,
    "local": plan}. The drop-path draws come first, so a step without
    RoPE augmentation draws what it drew before the factors existed."""
    if "packed" in rows:
        plan = packed_pass_plan(generator, n_blocks, rows["packed"], rate, mode)
        if rope_aug is not None:
            plan["rope"] = {k: rope_plan(generator, rope_aug) for k in CROP_KINDS}
        return plan
    plans = {k: packed_pass_plan(generator, n_blocks, rows[k], rate, mode)
             for k in CROP_KINDS}
    if rope_aug is not None:
        for k in CROP_KINDS:
            plans[k]["rope"] = rope_plan(generator, rope_aug)
    return plans


def _fold_in_drop_path(key: tuple, n_blocks: int, rows: int, rate: float,
                       mode: str) -> dict:
    """A pass's drop-path plan, block i's draws from the generator of
    ``key + (0, i)``: a permutation a branch (subset) or the two
    branches' keep bits (mask)."""
    if rate <= 0.0:
        return {}
    subset = resolve_drop_path(rows, rate, mode) == "subset"
    keep = subset_keep_count(rows, rate)
    blocks = []
    for i in range(n_blocks):
        g = key_generator(*key, 0, i)
        if subset:
            blocks.append(torch.stack([
                torch.sort(torch.randperm(rows, generator=g)[:keep]).values
                for _ in range(2)]))
        else:
            blocks.append(torch.rand((2, rows), generator=g) < 1.0 - rate)
    return {"drop_path": {"idx" if subset else "keep": torch.stack(blocks)}}


def fold_in_plan(seed: int, iteration: int, microbatch: int | None = None, *,
                 n_blocks: int, rows: dict, rate: float, mode: str = "subset",
                 rope_aug: tuple | None = None) -> dict:
    """``rng.plan=false``: the plan of ``step_plan``'s structure, each
    pass's draws from its own generators, keyed by (seed, iteration[,
    microbatch], pass) and the block (``_fold_in_drop_path``); a crop
    kind's RoPE factors from the generator of its pass key and 1, in the
    three draws of ``ops/rope.py augment_coords``."""
    base = (seed, iteration) + (() if microbatch is None else (microbatch,))

    def factors(kind):
        return augment_coords(key_generator(*base, PASS_TAGS[kind], 1), *rope_aug)

    if "packed" in rows:
        plan = _fold_in_drop_path(base + (PASS_TAGS["packed"],), n_blocks,
                                  rows["packed"], rate, mode)
        if rope_aug is not None:
            plan["rope"] = {k: factors(k) for k in CROP_KINDS}
        return plan
    plans = {k: _fold_in_drop_path(base + (PASS_TAGS[k],), n_blocks, rows[k],
                                   rate, mode) for k in CROP_KINDS}
    if rope_aug is not None:
        for k in CROP_KINDS:
            plans[k]["rope"] = factors(k)
    return plans


def convnext_plan(seed: int, iteration: int, microbatch: int | None = None, *,
                  rates: list, rows: dict) -> dict:
    """A ConvNeXt student's two passes' plans, {"global": plan, "local":
    plan}, each {"drop_path": {"keep": [n_blocks, rows]}} keep bits of the
    per-sample mask (``ops/drop_path.py DropPath``), block i's True with
    probability 1 - rates[i], drawn from the generator of (seed,
    iteration[, microbatch], pass, 0, i); {} for a pass without drop path.
    The JAX ConvNeXt draws its masks in its modules, never from a step
    plan, so these bits are the port's own."""
    base = (seed, iteration) + (() if microbatch is None else (microbatch,))
    if not any(r > 0.0 for r in rates):
        return {k: {} for k in CROP_KINDS}
    return {k: {"drop_path": {"keep": torch.stack([
        mask_keep_bits(key_generator(*base, PASS_TAGS[k], 0, i), rows[k], r)
        for i, r in enumerate(rates)])}} for k in CROP_KINDS}


def plan_to_device(plan: dict | None, device) -> dict:
    """A plan (torch or numpy arrays, e.g. the JAX plan's) on ``device``:
    indices as int64, keep bits as bool, RoPE factors as fp32."""
    out = {}
    for key, value in (plan or {}).items():
        if isinstance(value, dict):
            out[key] = plan_to_device(value, device)
            continue
        t = value if torch.is_tensor(value) else torch.from_numpy(np.array(value))
        dtype = {"keep": torch.bool, "idx": torch.int64}.get(key, torch.float32)
        # non_blocking: from pageable memory the copy is staged at once, so
        # the host does not wait for the queued work
        out[key] = t.to(device, dtype, non_blocking=True)
    return out


def plan_layer_slice(plan: dict | None, i: int) -> dict | None:
    """Block i's slice of a pass plan's stacked drop-path arrays."""
    if not plan or "drop_path" not in plan:
        return None
    return {k: v[i] for k, v in plan["drop_path"].items()}
