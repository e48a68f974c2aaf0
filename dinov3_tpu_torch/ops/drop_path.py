"""Stochastic depth with precomputed plans (``dinov3_tpu/ops/drop_path.py``).

Batch-subset semantics (the reference's): a residual branch runs on a
``floor(B * (1 - rate))``-row subset and its ``B / keep``-scaled output is
added back at those rows, so dropped rows skip the branch compute. The kept
rows come from the step's plan (``rng/plan.py``), sorted and unique; the
per-sample mask form takes precomputed keep bits. The port runs on one
device, so the subset is drawn over the whole batch (one group).
"""

from __future__ import annotations

from typing import Callable

import torch


def subset_keep_count(batch: int, rate: float) -> int:
    """floor(B * (1 - rate)), at least 1."""
    return max(1, int(batch * (1.0 - rate)))


def resolve_drop_path(batch: int, rate: float, mode: str) -> str:
    """The drop-path mode of one forward pass on one device (one group):
    "subset", or "mask" where asked for or where the batch is too small
    for the rate (subsetting would keep every row)."""
    if mode not in ("subset", "mask"):
        raise ValueError(f"unknown drop_path_mode {mode!r}; expected subset|mask")
    if mode == "subset" and subset_keep_count(batch, rate) < batch:
        return "subset"
    return "mask"


def _gather_aux(aux, idx):
    return {k: (None if v is None else
                tuple(t.index_select(0, idx) for t in v) if isinstance(v, tuple)
                else v.index_select(0, idx))
            for k, v in aux.items()}


def subset_residual_planned(x: torch.Tensor, branch: Callable, idx: torch.Tensor,
                            aux: dict | None = None) -> torch.Tensor:
    """``x + drop_path(branch(x))`` on the kept rows ``idx`` [keep] (sorted,
    unique). Per-row context in ``aux`` (the packed batch's RoPE tables and
    segment ids) is gathered with the rows, so the branch sees each row's
    own. The branch output is scaled by B / keep, cast to x's dtype and
    added at the kept rows; the other rows pass through."""
    B, keep = x.shape[0], idx.shape[0]
    xs = x.index_select(0, idx)
    res = branch(xs) if aux is None else branch(xs, _gather_aux(aux, idx))
    return x.index_add(0, idx, (res * (B / keep)).to(x.dtype))


def mask_residual_planned(x: torch.Tensor, branch_out: torch.Tensor,
                          keep_bits: torch.Tensor, rate: float) -> torch.Tensor:
    """Per-sample mask semantics with precomputed keep bits [B] bool."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    masked = torch.where(keep_bits.reshape(shape), branch_out / keep,
                         torch.zeros_like(branch_out))
    return x + masked.to(x.dtype)


class DropPath(torch.nn.Module):
    """Per-sample Bernoulli residual mask (``dinov3_tpu/ops/drop_path.py``
    ``DropPath``, the ConvNeXt stages' form): the branch runs for every
    sample and a dropped sample's output is zeroed, a kept one's scaled by
    1 / keep. The keep bits [B] bool come in with the call (a pass plan's
    slice, drawn from an explicit generator by ``rng/plan.py``); the
    module draws nothing itself."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, keep_bits: torch.Tensor | None = None) -> torch.Tensor:
        if self.rate == 0.0 or keep_bits is None:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return torch.where(keep_bits.reshape(shape), x / keep,
                           torch.zeros_like(x)).to(x.dtype)


def mask_keep_bits(generator: torch.Generator, batch: int, rate: float) -> torch.Tensor:
    """[B] bool keep bits of ``DropPath``, each True with probability
    1 - rate, from ``generator`` (never the global RNG)."""
    return torch.rand(batch, generator=generator) < 1.0 - rate
