"""The continuous-packing serve engine (``dinov3_tpu/serve/engine.py``).

``PackedServeEngine`` packs ragged traffic into fixed [R, N] planes on
the host (``batcher.py``) and runs each pack through one segment-masked
ViT forward (``packed_feature_forward``) under ``torch.inference_mode``.
Per-segment features land in a preallocated device ring at a rotating
slot (``ServeRing``, written in place: the port's form of the JAX
engine's donated ring), and the host reads each pack's slot back in one
device-to-host copy.

Not ported yet: the per-image oracle engine, int8 weights, the fleet and
cache layers, the observer telemetry hook, and CUDA graphs in place of
the JAX engine's one ahead-of-time compile.
"""

from __future__ import annotations

import numpy as np
import torch

from dinov3_tpu_torch.configs.config import (
    continuous_packing_wished,
    serve_pad_waste_floor,
    serve_patch_features_wished,
    warn_serve_pad_waste,
)
from dinov3_tpu_torch.serve.batcher import ContinuousBatcher, PackPlan, ServeLayout
from dinov3_tpu_torch.serve.types import ServeRequest, ServeResponse
from dinov3_tpu_torch.serve.weights import load_serving_model

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
        """One slot's planes as numpy, from ONE device-to-host copy."""
        flat = self.flat[slot].cpu().numpy()
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
            torch.tensor(float(stamp), device=seg.device)]))

    return step


class PackedServeEngine:
    """Continuous-packing engine: ragged traffic, fixed-shape packs."""

    def __init__(self, model, layout: ServeLayout, flush_ms: float = 10.0,
                 ring_depth: int = 2, warn: bool = True,
                 patch_features: bool = False):
        self.model = model
        self.layout = layout
        self.device = next(model.parameters()).device
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
        self.packs_run = 0
        self._waste_used = 0
        self._waste_total = 0

    @property
    def mean_pad_waste(self) -> float | None:
        """Padding fraction over all packs run."""
        if not self._waste_total:
            return None
        return 1.0 - self._waste_used / self._waste_total

    # ---------------- serving ----------------

    def submit(self, image, request_id: int, arrival_s: float = 0.0,
               slo: str = "default") -> None:
        self.batcher.admit(ServeRequest(
            request_id=request_id, image=np.asarray(image, np.float32),
            arrival_s=arrival_s, slo=slo))

    @property
    def queue_len(self) -> int:
        return self.batcher.queue_len

    def flush(self) -> list[ServeResponse]:
        """Run ONE pack off the queue (callers loop while queue_len)."""
        plan = self.batcher.next_pack()
        if plan is None:
            return []
        return self.run_pack(plan)

    def run_pack(self, plan: PackPlan) -> list[ServeResponse]:
        planes = plan.planes
        slot = self._slot
        self._slot = (slot + 1) % self.ring_depth
        stamp = self.packs_run
        with torch.inference_mode():
            dev = {k: torch.from_numpy(planes[k]).to(self.device)
                   for k in ("patches", "coords", "prefix_idx", "seg",
                             "cls_index")}
            self._step(self._ring, dev["patches"], dev["coords"],
                       dev["prefix_idx"], dev["seg"], dev["cls_index"],
                       slot, stamp)
            host = self._ring.host_slot(slot)
        self.packs_run += 1
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
                       device="cuda", seed: int = 0,
                       warn: bool = True) -> PackedServeEngine:
    """The config-level entry: weights (or a seeded init) -> bf16 serving
    model on ``device`` -> the packed engine."""
    if not continuous_packing_wished(cfg):
        raise NotImplementedError(
            "serve.continuous_packing=false selects the per-shape oracle "
            "engine, which is not ported yet")
    model = load_serving_model(cfg, state_dict, device=device, seed=seed)
    s = cfg.get("serve") or {}
    return PackedServeEngine(
        model, serve_layout_from_cfg(cfg),
        flush_ms=float(s.get("flush_ms", 10.0) or 10.0),
        ring_depth=int(s.get("ring_depth", 2) or 2), warn=warn,
        patch_features=serve_patch_features_wished(cfg))
