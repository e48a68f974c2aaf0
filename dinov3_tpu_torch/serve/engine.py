"""The serve engines (``dinov3_tpu/serve/engine.py``).

``PackedServeEngine`` (the default, ``serve.continuous_packing``) packs
ragged traffic into fixed [R, N] planes on the host (``batcher.py``) and
runs each pack through one segment-masked ViT forward
(``packed_feature_forward``) under ``torch.inference_mode``: one
fixed-shape program, so ``compile_count`` is 1. Per-segment features and a
stats row land in a preallocated device ring at a rotating slot
(``ServeRing``, written in place: the port's form of the JAX engine's
donated ring), and the host reads each pack's slot back through the
counted funnel (``telemetry/host_sync.py blocking_fetch``): one
device-to-host copy, the pack's one synchronizing call (the planes go up
with ``non_blocking`` copies). It serves a bf16 model or its int8 twin
(``quant.py``).

``OracleServeEngine`` (``serve.continuous_packing=false``) is the naive
reference: ``per_image`` runs one forward per request; ``rectangular``
groups a flush's requests by (h, w) and pads each group's batch to the
next power of two. Both read ``x_norm_clstoken`` and the mean of
``x_norm_patchtokens`` off the model's standard ``forward``, one fetch a
group. Its ``compile_count`` is the number of distinct (Bp, h, w) input
shapes it dispatched, the counterpart of the reference's jit cache.

Both engines share the batcher's admission and flush-deadline policy
(``should_flush``, ``flush_deadline``) and call an attached
``telemetry.ServeObserver`` (``observer``) at admission and after each
pack, adding no sync of their own.

Not ported yet: CUDA graphs for the packed step in place of the
reference's one ahead-of-time compile, and pinned host buffers for the
plane copies (speed-ups with no new behaviour).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dinov3_tpu_torch.configs.config import (
    continuous_packing_wished,
    serve_pad_waste_floor,
    serve_patch_features_wished,
    warn_serve_pad_waste,
)
from dinov3_tpu_torch.serve.batcher import ContinuousBatcher, PackPlan, ServeLayout
from dinov3_tpu_torch.serve.quant import is_quantized
from dinov3_tpu_torch.serve.types import ServeRequest, ServeResponse
from dinov3_tpu_torch.serve.weights import load_serving_model
from dinov3_tpu_torch.telemetry.host_sync import blocking_fetch

# field order of the ServeRing.stats row
SERVE_STATS_FIELDS = ("tokens_used", "n_segments", "pad_tokens", "stamp")


class ServeRing:
    """Preallocated output planes, one flat fp32 buffer per slot so a
    pack's results come back in one copy: per slot, CLS [R, S, D],
    pooled-patch [R, S, D], the per-token patch plane [R, N_p, D]
    (N_p = 0 unless patch features are served) and a stats row
    (SERVE_STATS_FIELDS)."""

    def __init__(self, depth: int, rows: int, n_slots: int, embed_dim: int,
                 patch_tokens: int = 0, device="cpu"):
        feat = rows * n_slots * embed_dim
        patch = rows * patch_tokens * embed_dim
        n_stats = len(SERVE_STATS_FIELDS)
        self.flat = torch.zeros((depth, 2 * feat + patch + n_stats),
                                dtype=torch.float32, device=device)
        self.cls = self.flat[:, :feat].view(depth, rows, n_slots, embed_dim)
        self.pooled = self.flat[:, feat:2 * feat].view(
            depth, rows, n_slots, embed_dim)
        self.patch = self.flat[:, 2 * feat:2 * feat + patch].view(
            depth, rows, patch_tokens, embed_dim)
        self.stats = self.flat[:, 2 * feat + patch:]

    def host_slot(self, slot: int) -> dict:
        """One slot's planes as numpy, from one counted device-to-host
        copy (``blocking_fetch``)."""
        flat = blocking_fetch(self.flat[slot]).numpy()
        shape = tuple(self.cls.shape[1:])
        feat = int(np.prod(shape))
        pshape = tuple(self.patch.shape[1:])
        patch = int(np.prod(pshape))
        return {
            "cls": flat[:feat].reshape(shape),
            "pooled": flat[feat:2 * feat].reshape(shape),
            "patch": flat[2 * feat:2 * feat + patch].reshape(pshape),
            "stats": flat[2 * feat + patch:],
        }


def make_serve_step(model, n_slots: int, patch_features: bool = False):
    """The serve step: packed planes -> per-segment features written in
    place into ``ring`` at ``slot``.

    Each segment's CLS row is gathered from the CLS-normed plane at its
    host-recorded position; its pooled patch feature is a masked mean
    over the patch-normed plane (one [R, S, N] x [R, N, D] product, the
    counts clamped at 1). The stats row is computed from the same seg
    plane the forward consumed."""

    def step(ring: ServeRing, patches, coords, prefix_idx, seg, cls_index,
             slot: int, stamp: int) -> None:
        out = model.packed_feature_forward(patches, coords, prefix_idx, seg)
        cls_rows = out["cls_rows"].float()
        patch_rows = out["patch_rows"].float()
        D = cls_rows.shape[-1]
        idx = cls_index.long()[..., None].expand(-1, -1, D)
        cls = torch.gather(cls_rows, 1, idx)
        is_patch = (prefix_idx < 0) & (seg >= 0)
        slots = torch.arange(n_slots, device=seg.device)
        sel = ((seg[:, None, :] == slots[None, :, None])
               & is_patch[:, None, :]).float()
        counts = sel.sum(-1)
        pooled = torch.einsum("rsn,rnd->rsd", sel, patch_rows)
        pooled = pooled / counts.clamp_min(1.0)[..., None]
        ring.cls[slot].copy_(cls)
        ring.pooled[slot].copy_(pooled)
        if patch_features:
            ring.patch[slot].copy_(patch_rows)
        tokens_used = (seg >= 0).sum().float()
        n_segments = (counts > 0).sum().float()
        budget = float(seg.shape[0] * seg.shape[1])
        ring.stats[slot].copy_(torch.stack([
            tokens_used, n_segments, budget - tokens_used,
            tokens_used.new_full((), float(stamp))]))

    return step


class _Admission:
    """The admission and flush-deadline protocol both engines share."""

    def submit(self, image, request_id: int, arrival_s: float = 0.0,
               slo: str = "default") -> None:
        req = ServeRequest(
            request_id=request_id, image=np.asarray(image, np.float32),
            arrival_s=arrival_s, slo=slo)
        self.batcher.admit(req)
        if self.observer is not None:
            h, w = req.hw
            self.observer.on_admit(request_id, slo,
                                   self.layout.seq_len(h, w), h, w)

    @property
    def queue_len(self) -> int:
        return self.batcher.queue_len

    def should_flush(self, now: float) -> bool:
        return self.batcher.should_flush(now)

    def flush_deadline(self):
        return self.batcher.flush_deadline()

    @property
    def mean_pad_waste(self) -> float | None:
        """Padding fraction over all packs since the last reset
        (``last_pad_waste`` is one pack's; a drained queue's last pack is
        usually partial)."""
        if not self._waste_total:
            return None
        return 1.0 - self._waste_used / self._waste_total

    def reset_pad_stats(self) -> None:
        self._waste_used = 0
        self._waste_total = 0


class PackedServeEngine(_Admission):
    """Continuous-packing engine: ragged traffic, fixed-shape packs."""

    def __init__(self, model, layout: ServeLayout, flush_ms: float = 10.0,
                 ring_depth: int = 2, warn: bool = True,
                 patch_features: bool = False):
        self.model = model
        self.layout = layout
        self.device = next(model.parameters()).device
        self.weights_dtype = "int8" if is_quantized(model) else "bf16"
        self.arm = "packed_int8" if self.weights_dtype == "int8" else "packed"
        self.batcher = ContinuousBatcher(layout, flush_ms=flush_ms)
        self.ring_depth = int(ring_depth)
        self.patch_features = bool(patch_features)
        self._slot = 0
        with torch.inference_mode():
            self._ring = ServeRing(
                self.ring_depth, layout.rows, layout.max_segments_per_row,
                model.embed_dim,
                patch_tokens=layout.row_tokens if self.patch_features else 0,
                device=self.device)
        if warn:
            floor = serve_pad_waste_floor(
                layout.row_tokens, layout.patch_size, layout.n_prefix,
                layout.min_px, layout.max_px)
            warn_serve_pad_waste(
                floor["mean_waste"],
                axis=f"serve row budget over the {layout.min_px}.."
                     f"{layout.max_px}px envelope (uniform mix; worst "
                     f"single resolution {floor['px']}px wastes "
                     f"{floor['waste']:.0%})")
        self._step = make_serve_step(model, layout.max_segments_per_row,
                                     patch_features=self.patch_features)
        self.step_builds = 1  # the engine's one fixed-shape step
        self.packs_run = 0
        self.last_pad_waste: float | None = None
        self._waste_used = 0
        self._waste_total = 0
        # a telemetry.ServeObserver, or None: admission and per-pack
        # phase timings flow through it; the engine never waits for it
        self.observer = None

    @property
    def compile_count(self) -> int:
        """Distinct programs the engine runs: its step builds, one
        fixed-shape step."""
        return self.step_builds

    def flush(self) -> list[ServeResponse]:
        """Run ONE pack off the queue (callers loop while queue_len)."""
        t0 = time.perf_counter()
        plan = self.batcher.next_pack()
        if plan is None:
            return []
        return self.run_pack(plan, placement_ms=(time.perf_counter() - t0) * 1e3)

    def run_pack(self, plan: PackPlan,
                 placement_ms: float | None = None) -> list[ServeResponse]:
        planes = plan.planes
        slot = self._slot
        self._slot = (slot + 1) % self.ring_depth
        stamp = self.packs_run
        t_disp0 = time.perf_counter()
        with torch.inference_mode():
            # pageable copies, staged by CUDA before they return: no
            # wait for the card here, the ring fetch is the pack's one
            dev = {k: torch.from_numpy(planes[k]).to(self.device, non_blocking=True)
                   for k in ("patches", "coords", "prefix_idx", "seg",
                             "cls_index")}
            self._step(self._ring, dev["patches"], dev["coords"],
                       dev["prefix_idx"], dev["seg"], dev["cls_index"],
                       slot, stamp)
            t_disp1 = time.perf_counter()
            host = self._ring.host_slot(slot)
        t_fetch1 = time.perf_counter()
        self.packs_run += 1
        self.last_pad_waste = plan.pad_waste
        self._waste_used += plan.tokens_used
        self._waste_total += self.layout.token_budget
        npfx = self.layout.n_prefix
        out = []
        for pl in plan.placements:
            patch_tokens = None
            if self.patch_features:
                # the request's tokens: the contiguous span
                # [offset + n_prefix, offset + n_prefix + n_patches)
                a = pl.offset + npfx
                patch_tokens = host["patch"][pl.row, a:a + pl.n_patches].copy()
            out.append(ServeResponse(
                request_id=pl.request.request_id,
                cls_feature=host["cls"][pl.row, pl.slot].copy(),
                pooled_patch_feature=host["pooled"][pl.row, pl.slot].copy(),
                n_patches=pl.n_patches,
                patch_tokens=patch_tokens,
                arrival_s=pl.request.arrival_s,
                slo=pl.request.slo,
            ))
        if self.observer is not None:
            t_done = time.perf_counter()
            # the fetch fences the device work: device and fetch are both
            # the dispatch-return -> fetch-return wall
            dev_ms = (t_fetch1 - t_disp1) * 1e3
            self.observer.on_pack(
                plan.placement_summary(),
                {"placement": placement_ms,
                 "dispatch": (t_disp1 - t_disp0) * 1e3,
                 "device": dev_ms, "fetch": dev_ms,
                 "extract": (t_done - t_fetch1) * 1e3},
                device_stats=dict(zip(SERVE_STATS_FIELDS,
                                      (float(v) for v in host["stats"]))),
                tokens_used=plan.tokens_used)
        return out


class OracleServeEngine(_Admission):
    """Naive serving oracle: one forward per batch shape.

    Shares the batcher's admission and flush-deadline policy, so latency
    replays compare like with like, but runs the model's standard
    ``forward`` per request (``per_image``) or per (h, w) group padded to
    a power of two (``rectangular``). ``compile_count`` grows with the
    traffic's shape diversity."""

    def __init__(self, model, layout: ServeLayout, flush_ms: float = 10.0,
                 mode: str = "rectangular", patch_features: bool = False):
        if mode not in ("per_image", "rectangular"):
            raise ValueError(
                f"serve.oracle={mode!r}: expected per_image|rectangular")
        self.model = model
        self.layout = layout
        self.device = next(model.parameters()).device
        self.mode = mode
        self.arm = f"oracle_{mode}"
        self.patch_features = bool(patch_features)
        self.batcher = ContinuousBatcher(layout, flush_ms=flush_ms)
        self.packs_run = 0
        self.last_pad_waste = 0.0
        self._waste_used = 0
        self._waste_total = 0
        self._shapes: set = set()
        self.observer = None

    @property
    def compile_count(self) -> int:
        """Distinct (Bp, h, w) input shapes dispatched so far."""
        return len(self._shapes)

    def _features(self, x: np.ndarray):
        """Dispatch one batch; returns the device tensors to fetch."""
        self._shapes.add(x.shape[:3])
        with torch.inference_mode():
            out = self.model(torch.from_numpy(x).to(self.device, non_blocking=True))
            patches = out["x_norm_patchtokens"].float()
            fetch = (out["x_norm_clstoken"].float(), patches.mean(1))
        return fetch + ((patches,) if self.patch_features else ())

    def flush(self) -> list[ServeResponse]:
        t_place0 = time.perf_counter()
        reqs = self.batcher.drain()
        if not reqs:
            return []
        self.packs_run += 1
        out: list[ServeResponse] = []
        if self.mode == "per_image":
            groups = [[r] for r in reqs]
        else:
            by_hw: dict = {}
            for r in reqs:
                by_hw.setdefault(r.hw, []).append(r)
            groups = list(by_hw.values())
        placement_ms = (time.perf_counter() - t_place0) * 1e3
        used = padded = 0
        dispatch_ms = fetch_ms = 0.0
        t_run0 = time.perf_counter()
        for group in groups:
            B = len(group)
            Bp = 1 << (B - 1).bit_length() if self.mode == "rectangular" else B
            x = np.zeros((Bp,) + group[0].image.shape, np.float32)
            for i, r in enumerate(group):
                x[i] = r.image
            t0 = time.perf_counter()
            pending = self._features(x)
            t1 = time.perf_counter()
            fetched = [t.numpy() for t in blocking_fetch(pending)]
            dispatch_ms += (t1 - t0) * 1e3
            fetch_ms += (time.perf_counter() - t1) * 1e3
            cls, pooled = fetched[:2]
            patches = fetched[2] if self.patch_features else None
            seq = self.layout.seq_len(*group[0].hw)
            used += B * seq
            padded += Bp * seq
            for i, r in enumerate(group):
                out.append(ServeResponse(
                    request_id=r.request_id, cls_feature=cls[i].copy(),
                    pooled_patch_feature=pooled[i].copy(),
                    n_patches=seq - self.layout.n_prefix,
                    patch_tokens=None if patches is None else patches[i].copy(),
                    arrival_s=r.arrival_s, slo=r.slo))
        self.last_pad_waste = 1.0 - used / padded if padded else 0.0
        self._waste_used += used
        self._waste_total += padded
        if self.observer is not None:
            t_done = time.perf_counter()
            self.observer.on_pack(
                [(r.request_id, r.slo, self.layout.seq_len(*r.hw))
                 for r in reqs],
                {"placement": placement_ms, "dispatch": dispatch_ms,
                 # no packed stats plane here; device time is the grouped
                 # run minus its dispatches
                 "device": (t_done - t_run0) * 1e3 - dispatch_ms,
                 "fetch": fetch_ms, "extract": None},
                device_stats=None, tokens_used=used, token_budget=padded)
        return out


# ---------------- config-level construction ----------------


def serve_layout_from_cfg(cfg) -> ServeLayout:
    """serve.* config block -> static layout. ``row_tokens=auto`` sizes
    each row to hold two max-envelope images."""
    s = cfg.get("serve") or {}
    st = cfg.student
    p = int(st.patch_size)
    n_prefix = 1 + int(st.get("n_storage_tokens", 0) or 0)
    max_px = int(s.get("max_px", 512) or 512)
    rt = s.get("row_tokens", "auto")
    if rt in (None, "auto") or (isinstance(rt, str) and rt.lower() == "auto"):
        row_tokens = 2 * (n_prefix + (max_px // p) ** 2)
    else:
        row_tokens = int(rt)
    return ServeLayout(
        rows=int(s.get("rows", 4) or 4),
        row_tokens=row_tokens,
        n_prefix=n_prefix,
        max_segments_per_row=int(s.get("max_segments_per_row", 8) or 8),
        patch_size=p,
        in_chans=int(st.get("in_chans", 3) or 3),
        normalize=str(st.get("pos_embed_rope_normalize_coords", "separate")),
        min_px=int(s.get("min_px", 96) or 96),
        max_px=max_px,
    )


def build_serve_engine(cfg, state_dict: dict | None = None, *,
                       ckpt_dir: str | None = None, device="cuda",
                       seed: int = 0, warn: bool = True, meta_weights=None):
    """The config-level entry: weights (``state_dict``), the EMA teacher
    of a training checkpoint (``ckpt_dir``), Meta release weights
    (``meta_weights``, a Meta-named ``state_dict`` or its file) or a seeded
    init -> bf16 serving model on ``device`` -> the packed engine, or with
    ``serve.continuous_packing=false`` the oracle named by
    ``serve.oracle``."""
    model = load_serving_model(cfg, state_dict, ckpt_dir=ckpt_dir,
                               device=device, seed=seed, meta_weights=meta_weights)
    s = cfg.get("serve") or {}
    layout = serve_layout_from_cfg(cfg)
    flush_ms = float(s.get("flush_ms", 10.0) or 10.0)
    patch_features = serve_patch_features_wished(cfg)
    if continuous_packing_wished(cfg):
        return PackedServeEngine(
            model, layout, flush_ms=flush_ms,
            ring_depth=int(s.get("ring_depth", 2) or 2), warn=warn,
            patch_features=patch_features)
    return OracleServeEngine(
        model, layout, flush_ms=flush_ms,
        mode=str(s.get("oracle", "rectangular") or "rectangular"),
        patch_features=patch_features)
