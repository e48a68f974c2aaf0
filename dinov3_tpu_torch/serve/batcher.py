"""Continuous multi-image packing: ragged traffic -> fixed-shape planes.

Host numpy, a copy of ``dinov3_tpu/serve/batcher.py`` (the planes are
held bitwise equal to the JAX batcher's by the tests). Requests are
admitted into the open pack until the token budget or a flush deadline is
hit; each image's token span goes to a row first-fit over sizes sorted
decreasing (FFD), and the fixed-shape planes the packed forward consumes
(``models/vision_transformer.py packed_feature_forward``) are assembled:

- ``patches``   [R, N, p, p, C] f32 — host-patchified pixels,
- ``coords``    [R, N, 2]       f32 — per-segment RoPE patch coords,
- ``prefix_idx``[R, N]          i32 — CLS/storage slots (-1 = patch/pad),
- ``seg``       [R, N]          i32 — segment ids (-1 = pad: pads attend
  only among themselves, their outputs are dropped),
- ``cls_index`` [R, S]          i32 — where each segment's CLS landed.

The planes live in staging buffers allocated once and refilled per pack.
Each [p, p, C] patch keeps PatchEmbed's row-major inner layout
(``ops/patch_embed.py``), and the coordinates reproduce
``ops/rope.py patch_coords`` in f32.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from dinov3_tpu_torch.serve.types import ServeRequest


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """Static shape plan for the serve step — the serving analogue of
    ops/packing.PackedLayout (fixed rows x row_tokens instead of the
    trainer's global/local split)."""

    rows: int                 # R packed rows per device program
    row_tokens: int           # N tokens per row (prefix + patches + pad)
    n_prefix: int             # 1 + n_storage_tokens per segment
    max_segments_per_row: int  # S extraction slots per row
    patch_size: int
    in_chans: int = 3
    normalize: str = "separate"  # rope coord normalization mode
    min_px: int = 64             # admissible resolution envelope —
    max_px: int = 512            # drives the pad-waste-floor guardrail

    @property
    def token_budget(self) -> int:
        return self.rows * self.row_tokens

    def seq_len(self, h_px: int, w_px: int) -> int:
        """Token span of one image: prefix + patch grid."""
        p = self.patch_size
        if h_px % p or w_px % p:
            raise ValueError(
                f"image size {(h_px, w_px)} not divisible by patch {p}")
        return self.n_prefix + (h_px // p) * (w_px // p)

    def admits(self, h_px: int, w_px: int) -> bool:
        """Whether this layout can serve an (h, w) request at all:
        patch-divisible and the token span fits one row. The fleet
        admission layer (serve/fleet.py FleetRouter.route) keys on
        this — capacity, not the px advisory envelope (min_px/max_px
        drive the pad-waste guardrail, not correctness)."""
        p = self.patch_size
        if h_px % p or w_px % p:
            return False
        return self.seq_len(h_px, w_px) <= self.row_tokens


def patchify(image: np.ndarray, patch_size: int) -> np.ndarray:
    """[H, W, C] -> [h*w, p, p, C], PatchEmbed's patch order and
    row-major [p, p, C] inner layout (ops/patch_embed.py:42)."""
    H, W, C = image.shape
    p = patch_size
    h, w = H // p, W // p
    x = image.reshape(h, p, w, p, C).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(x.reshape(h * w, p, p, C))


def patch_coords_np(h: int, w: int, normalize: str = "separate") -> np.ndarray:
    """[h*w, 2] f32 patch-center coords in [-1, 1] — the numpy twin of
    ops/rope.patch_coords (same f32 arithmetic, bitwise on CPU)."""
    if normalize == "max":
        denom_h = denom_w = max(h, w)
    elif normalize == "min":
        denom_h = denom_w = min(h, w)
    elif normalize == "separate":
        denom_h, denom_w = h, w
    else:
        raise ValueError(f"unknown normalize mode {normalize!r}")
    ch = (np.arange(h, dtype=np.float32) + np.float32(0.5)) / np.float32(denom_h)
    cw = (np.arange(w, dtype=np.float32) + np.float32(0.5)) / np.float32(denom_w)
    coords = np.stack(np.meshgrid(ch, cw, indexing="ij"), axis=-1).reshape(-1, 2)
    return np.float32(2.0) * coords - np.float32(1.0)


@dataclasses.dataclass
class Placement:
    """One request's span inside a pack: row, extraction slot, token
    offset, and patch grid."""

    request: ServeRequest
    row: int
    slot: int
    offset: int
    h: int
    w: int

    @property
    def n_patches(self) -> int:
        return self.h * self.w


class PackPlan:
    """One assembled pack: the filled planes (views of the batcher's
    staging buffers — valid until the next ``next_pack``) plus the
    placement list the engine extracts responses with."""

    def __init__(self, layout: ServeLayout, placements: list[Placement],
                 planes: dict):
        self.layout = layout
        self.placements = placements
        self.planes = planes
        self.tokens_used = sum(
            layout.n_prefix + pl.n_patches for pl in placements)

    @property
    def pad_waste(self) -> float:
        """Fraction of the token budget spent on padding (empty row
        tails + unused rows) — the serve analogue of
        PackedLayout.pad_waste, fed to the warn_serve_pad_waste
        guardrail (configs/config.py)."""
        return 1.0 - self.tokens_used / self.layout.token_budget

    @property
    def n_segments(self) -> int:
        return len(self.placements)

    @property
    def pad_tokens(self) -> int:
        return self.layout.token_budget - self.tokens_used

    def placement_summary(self) -> list:
        """Host-side per-request view for the observability plane
        (telemetry/serve_obs.py): ``(request_id, slo, seq_len)`` per
        placement — the twin of the device-computed stats row the
        engine fetches off the ring, so scripts/obs_report.py can
        census host/device agreement."""
        return [(pl.request.request_id, pl.request.slo,
                 self.layout.n_prefix + pl.n_patches)
                for pl in self.placements]


class ContinuousBatcher:
    """Admit -> (budget | deadline) -> FFD row assignment -> planes.

    ``flush_ms`` bounds how long the oldest admitted request waits
    before a partially-filled pack ships (the latency side of the
    throughput/latency trade — docs/PERFORMANCE.md serving section).
    """

    def __init__(self, layout: ServeLayout, flush_ms: float = 10.0):
        self.layout = layout
        self.flush_ms = float(flush_ms)
        self._queue: deque[ServeRequest] = deque()
        self._queued_tokens = 0
        self._coords_cache: dict = {}
        L = layout
        # staging buffers, allocated once (module doc)
        self._patches = np.zeros(
            (L.rows, L.row_tokens, L.patch_size, L.patch_size, L.in_chans),
            np.float32)
        self._coords = np.zeros((L.rows, L.row_tokens, 2), np.float32)
        self._prefix_idx = np.zeros((L.rows, L.row_tokens), np.int32)
        self._seg = np.zeros((L.rows, L.row_tokens), np.int32)
        self._cls_index = np.zeros((L.rows, L.max_segments_per_row), np.int32)

    # ---------------- admission ----------------

    def admit(self, request: ServeRequest) -> None:
        seq = self.layout.seq_len(*request.hw)
        if seq > self.layout.row_tokens:
            raise ValueError(
                f"image {request.hw} needs {seq} tokens > row budget "
                f"{self.layout.row_tokens}; raise serve.row_tokens or "
                f"shrink the resolution envelope (serve.max_px)")
        self._queue.append(request)
        self._queued_tokens += seq

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    @property
    def queued_tokens(self) -> int:
        return self._queued_tokens

    def oldest_arrival(self) -> float | None:
        return self._queue[0].arrival_s if self._queue else None

    def drain(self) -> list[ServeRequest]:
        """Pop the whole queue in arrival order (the oracle arms share
        this batcher's admission/deadline policy but group their own
        batches — engine.py OracleServeEngine)."""
        out = list(self._queue)
        self._queue.clear()
        self._queued_tokens = 0
        return out

    def should_flush(self, now: float) -> bool:
        """Budget full, or the oldest request has waited out the flush
        deadline. The comparison reuses ``flush_deadline``'s exact
        arithmetic: a caller that advances its clock TO the deadline
        (the virtual-clock replay in scripts/bench_serve.py) must see
        True — computing the wait as ``(now - oldest) * 1e3`` instead
        rounds differently and can leave that caller stuck one ulp
        short of the deadline forever."""
        if not self._queue:
            return False
        if self._queued_tokens >= self.layout.token_budget:
            return True
        return now >= self.flush_deadline()

    def flush_deadline(self) -> float | None:
        old = self.oldest_arrival()
        return None if old is None else old + self.flush_ms * 1e-3

    # ---------------- packing ----------------

    def next_pack(self) -> PackPlan | None:
        """Pop as many queued requests as fit (FFD) and assemble planes.

        First-fit-decreasing: candidates sorted by token span
        descending (ties broken by arrival order — the sort is stable),
        each placed in the first row with enough remaining tokens and a
        free extraction slot. Requests that don't fit stay queued, in
        arrival order, for the next pack.
        """
        if not self._queue:
            return None
        L = self.layout
        order = sorted(range(len(self._queue)),
                       key=lambda i: -L.seq_len(*self._queue[i].hw))
        row_fill = [0] * L.rows
        row_segs = [0] * L.rows
        placements: list[Placement] = []
        taken = set()
        for i in order:
            req = self._queue[i]
            seq = L.seq_len(*req.hw)
            for r in range(L.rows):
                if (row_fill[r] + seq <= L.row_tokens
                        and row_segs[r] < L.max_segments_per_row):
                    placements.append(Placement(
                        request=req, row=r, slot=row_segs[r],
                        offset=row_fill[r],
                        h=req.image.shape[0] // L.patch_size,
                        w=req.image.shape[1] // L.patch_size))
                    row_fill[r] += seq
                    row_segs[r] += 1
                    taken.add(i)
                    break
        if not taken:
            return None
        self._queue = deque(
            req for i, req in enumerate(self._queue) if i not in taken)
        self._queued_tokens = sum(
            L.seq_len(*r.hw) for r in self._queue)
        return PackPlan(L, placements, self._fill_planes(placements))

    def _fill_planes(self, placements: list[Placement]) -> dict:
        L = self.layout
        self._patches.fill(0.0)
        self._coords.fill(0.0)
        self._prefix_idx.fill(-1)
        self._seg.fill(-1)
        self._cls_index.fill(0)
        for pl in placements:
            o, npx = pl.offset, L.n_prefix
            end = o + npx + pl.n_patches
            self._seg[pl.row, o:end] = pl.slot
            self._prefix_idx[pl.row, o:o + npx] = np.arange(npx)
            self._cls_index[pl.row, pl.slot] = o
            self._patches[pl.row, o + npx:end] = patchify(
                pl.request.image, L.patch_size)
            key = (pl.h, pl.w)
            if key not in self._coords_cache:
                self._coords_cache[key] = patch_coords_np(
                    pl.h, pl.w, L.normalize)
            self._coords[pl.row, o + npx:end] = self._coords_cache[key]
        return {
            "patches": self._patches, "coords": self._coords,
            "prefix_idx": self._prefix_idx, "seg": self._seg,
            "cls_index": self._cls_index,
        }
