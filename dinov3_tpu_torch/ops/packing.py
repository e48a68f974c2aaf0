"""Crop packing: k local-crop token sequences per global-length row
(``dinov3_tpu/ops/packing.py``, one device: ``groups=1``).

The student's 2B global rows and its n_l * B local sequences run through
ONE block stack: ``k = N_g // N_l`` local sequences are packed into each
global-length row, under segment-masked attention (``flash_attention``'s
``seg``) and per-segment RoPE tables (``ops/rope.py rope_packed_rows``).
Pad tokens (the row tail beyond ``k * N_l`` and the empty segments of the
ragged last row) carry segment id -1: they attend only among themselves,
no valid token attends them, and their outputs are dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static shape plan for one crop-packed student batch."""

    n_global_rows: int   # 2B global-crop rows
    n_local: int         # n_l * B local-crop sequences
    seq_global: int      # N_g = n_prefix + T_g
    seq_local: int       # N_l = n_prefix + T_l
    n_prefix: int        # 1 + n_storage_tokens

    @property
    def k(self) -> int:
        """Local sequences packed per global-length row."""
        return self.seq_global // self.seq_local

    @property
    def n_packed_rows(self) -> int:
        """P = ceil(n_local / k)."""
        return -(-self.n_local // self.k)

    @property
    def rows_total(self) -> int:
        return self.n_global_rows + self.n_packed_rows

    @property
    def pad_segments(self) -> int:
        """Empty segment slots in the ragged last packed row."""
        return self.n_packed_rows * self.k - self.n_local

    @property
    def pad_tokens_per_row(self) -> int:
        """Row-tail tokens beyond the k packed segments."""
        return self.seq_global - self.k * self.seq_local


def make_packed_layout(n_global_rows: int, n_local: int, seq_global: int,
                       seq_local: int, n_prefix: int) -> PackedLayout:
    if seq_local > seq_global:
        raise ValueError(
            f"local sequence ({seq_local}) longer than global "
            f"({seq_global}); nothing to pack")
    return PackedLayout(n_global_rows=n_global_rows, n_local=n_local,
                        seq_global=seq_global, seq_local=seq_local,
                        n_prefix=n_prefix)


def pack_local_rows(l_tokens: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """[n_local, N_l, D] -> [P, N_g, D]: k sequences per row, zero pad."""
    P, k, N_l = layout.n_packed_rows, layout.k, layout.seq_local
    x = F.pad(l_tokens, (0, 0, 0, 0, 0, layout.pad_segments))
    x = x.reshape(P, k * N_l, x.shape[-1])
    return F.pad(x, (0, 0, 0, layout.pad_tokens_per_row))


def split_packed_output(out, layout: PackedLayout):
    """[2B + P, N, D] (the global rows, then the packed rows) -> ([2B, N,
    D], [P, N, D])."""
    return out[: layout.n_global_rows], out[layout.n_global_rows:]


def packed_segment_ids(layout: PackedLayout) -> np.ndarray:
    """[R, N_g] int32 segment ids (host constant): 0 on global rows; on
    packed row p, token t: ``t // N_l`` while t < k * N_l and slot
    ``p * k + t // N_l`` holds a real local crop, else -1."""
    N, N_l, k = layout.seq_global, layout.seq_local, layout.k
    t = np.arange(N)
    base = np.where(t < k * N_l, t // N_l, -1)
    slot = np.arange(layout.n_packed_rows)[:, None] * k + base[None, :]
    seg_p = np.where((base[None, :] >= 0) & (slot < layout.n_local),
                     base[None, :], -1)
    seg_g = np.zeros((layout.n_global_rows, N), np.int64)
    return np.concatenate([seg_g, seg_p], axis=0).astype(np.int32)
