"""Engine pool and admission layer (``dinov3_tpu/serve/fleet.py``).

``FleetRouter`` puts several ``PackedServeEngine``s (a small-image fast
lane next to the full row, bf16 and int8 weight variants) behind one
admission layer that speaks the single engine's protocol (submit,
should_flush, flush_deadline, flush), so the replays of ``serve/bench.py``
drive a fleet unchanged.

Admission is deterministic, by request shape and SLO class: among the
engines whose layout admits the request (``ServeLayout.admits``), engines
that list the request's SLO class come before catch-alls
(``slo_classes=None``), then the smallest token budget wins, then the
spec order. No admitting engine is an error, never a silent fallback.

Engine envelopes come from measured traffic: ``layout_from_envelope``
turns a ``LiveMixTracker.recommended_serve_envelope()`` dict into a
fast-lane ``ServeLayout``, and ``FleetRouter.check_drift()`` re-fires the
pad-waste drift check per engine as the live mix moves.

The content-addressed cache (``cache.py``) sits in front of the engines:
a hit short-circuits at submit into ``_ready``, drained by the next
``flush()``; a miss is remembered and inserted when its engine's response
lands. Keys carry the target engine's weights fingerprint, so the bf16 and
int8 models of one checkpoint never share entries. Cache events and route
counts flow to a fleet-level ``ServeObserver`` (``on_cache``,
``on_route``) into the one span stream.

A single-engine fleet with no int8 and no cache is bitwise the bare
``PackedServeEngine`` (the same engine code; the router only tags the
engine name).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dinov3_tpu_torch.serve.batcher import ServeLayout
from dinov3_tpu_torch.serve.cache import FeatureCache, weights_fingerprint
from dinov3_tpu_torch.serve.types import ServeResponse


@dataclasses.dataclass
class EngineSpec:
    """One pool member: the engine, its routing contract, and the
    weights fingerprint its cache entries are keyed under.
    ``slo_classes=None`` = serves any class (the catch-all); a tuple
    restricts admission preference to those classes."""

    name: str
    engine: object
    slo_classes: tuple | None = None
    fingerprint: str = ""


def layout_from_envelope(base: ServeLayout, env: dict) -> ServeLayout:
    """A ``recommended_serve_envelope()`` dict (telemetry/serve_obs.py)
    -> a derived ``ServeLayout``: row shape and segment slots from the
    simulated-FFD search, px bounds from the observed mix when the
    tracker saw them — the measured-traffic fast lane."""
    kw = {
        "rows": int(env["rows"]),
        "row_tokens": int(env["row_tokens"]),
        "max_segments_per_row": int(env["max_segments_per_row"]),
    }
    if "min_px" in env:
        kw["min_px"] = int(env["min_px"])
    if "max_px" in env:
        kw["max_px"] = int(env["max_px"])
    return dataclasses.replace(base, **kw)


class FleetRouter:
    """The admission layer: routes, caches, tags, and aggregates.

    Speaks the single-engine protocol (submit / queue_len /
    should_flush / flush_deadline / flush), so callers written against
    ``PackedServeEngine`` drive a fleet unchanged. ``flush(now)`` runs
    one pack on every engine due at ``now`` (all queued engines when
    ``now`` is None — drain semantics) and prepends any cache hits
    ready since the last flush."""

    def __init__(self, specs: list, cache: FeatureCache | None = None,
                 observer=None):
        if not specs:
            raise ValueError("FleetRouter needs at least one EngineSpec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate engine names: {names}")
        fingerprints: dict = {}  # engines sharing a model hash it once
        for s in specs:
            if not s.fingerprint:
                key = id(s.engine.model)
                if key not in fingerprints:
                    fingerprints[key] = weights_fingerprint(s.engine.model)
                s.fingerprint = fingerprints[key]
        self.specs = list(specs)
        self.cache = cache
        self.observer = observer
        self.route_counts: dict[tuple, int] = {}
        self._ready: list[ServeResponse] = []
        self._pending_keys: dict[tuple, tuple] = {}

    # ---------------- admission ----------------

    def route(self, slo: str, h_px: int, w_px: int) -> EngineSpec:
        """Deterministic admission: admitting engines only; prefer an
        explicit SLO match over catch-alls; smallest token budget, then
        spec order, breaks ties."""
        fits = [(i, s) for i, s in enumerate(self.specs)
                if s.engine.layout.admits(h_px, w_px)]
        if not fits:
            raise ValueError(
                f"no engine admits a {h_px}x{w_px} request (slo={slo!r}); "
                f"fleet envelopes: "
                + ", ".join(f"{s.name}: row_tokens="
                            f"{s.engine.layout.row_tokens}"
                            for s in self.specs))
        explicit = [(i, s) for i, s in fits
                    if s.slo_classes is not None and str(slo) in s.slo_classes]
        pool = explicit or [(i, s) for i, s in fits
                            if s.slo_classes is None] or fits
        return min(pool, key=lambda t: (t[1].engine.layout.token_budget,
                                        t[0]))[1]

    def submit(self, image, request_id: int, arrival_s: float = 0.0,
               slo: str = "default") -> None:
        image = np.asarray(image, np.float32)
        h, w = int(image.shape[0]), int(image.shape[1])
        spec = self.route(slo, h, w)
        key = (spec.name, str(slo))
        self.route_counts[key] = self.route_counts.get(key, 0) + 1
        if self.observer is not None:
            self.observer.on_route(spec.name, slo)
        if self.cache is not None:
            ckey = self.cache.key(image, spec.fingerprint)
            val = self.cache.get(ckey)
            if val is not None:
                cls, pooled, n_patches = val
                self._ready.append(ServeResponse(
                    request_id=request_id, cls_feature=cls,
                    pooled_patch_feature=pooled, n_patches=n_patches,
                    arrival_s=arrival_s, slo=slo, engine=spec.name,
                    cache_hit=True))
                if self.observer is not None:
                    self.observer.on_cache("hit", request_id=request_id,
                                           slo=slo, engine=spec.name)
                return
            self._pending_keys[(spec.name, int(request_id))] = ckey
            if self.observer is not None:
                self.observer.on_cache("miss", request_id=request_id,
                                       slo=slo, engine=spec.name)
        spec.engine.submit(image, request_id, arrival_s=arrival_s, slo=slo)

    # ---------------- the single-engine protocol ----------------

    @property
    def queue_len(self) -> int:
        return len(self._ready) + sum(s.engine.queue_len
                                      for s in self.specs)

    def should_flush(self, now: float) -> bool:
        return bool(self._ready) or any(s.engine.should_flush(now)
                                        for s in self.specs)

    def flush_deadline(self):
        deadlines = [d for s in self.specs
                     if (d := s.engine.flush_deadline()) is not None]
        return min(deadlines) if deadlines else None

    def flush(self, now: float | None = None) -> list[ServeResponse]:
        """Cache hits ready since the last call, then one pack from
        every engine that is due (``now`` given) or queued (drain)."""
        out = self._ready
        self._ready = []
        for spec in self.specs:
            due = (spec.engine.queue_len if now is None
                   else spec.engine.should_flush(now))
            if not due:
                continue
            for r in spec.engine.flush():
                r.engine = spec.name
                pkey = self._pending_keys.pop(
                    (spec.name, int(r.request_id)), None)
                if pkey is not None and self.cache is not None:
                    evicted = self.cache.put(
                        pkey, (r.cls_feature, r.pooled_patch_feature,
                               r.n_patches))
                    if self.observer is not None:
                        self.observer.on_cache("insert",
                                               request_id=r.request_id,
                                               slo=r.slo, engine=spec.name)
                        if evicted:
                            self.observer.on_cache("evict",
                                                   engine=spec.name)
                out.append(r)
        return out

    # ---------------- accounting ----------------

    @property
    def compile_count(self) -> int:
        return sum(s.engine.compile_count for s in self.specs)

    def check_drift(self, threshold: float = 0.15,
                    warn: bool = True) -> dict:
        """Re-fire the per-engine live-mix pad-waste drift check (the
        ``LiveMixTracker.check_drift``) for every engine with an
        attached observer; {engine: warning-or-None}."""
        out = {}
        for s in self.specs:
            obs = getattr(s.engine, "observer", None)
            if obs is not None:
                out[s.name] = obs.mix.check_drift(
                    threshold=threshold, warn=warn, stacklevel=3)
        return out

    def finalize(self) -> dict:
        """Route/cache accounting for the bench record
        (``serve/bench.py _fleet_summary`` embeds this shape); emits one
        ``serve_fleet`` record into the span stream when an observer is
        attached."""
        out = {
            "n_engines": len(self.specs),
            "compile_count_total": self.compile_count,
            "route_counts": {f"{en}/{slo}": c for (en, slo), c
                             in sorted(self.route_counts.items())},
            "cache": self.cache.stats() if self.cache is not None else None,
        }
        if self.observer is not None:
            import time

            self.observer.emit({"name": "serve_fleet",
                                "t": round(time.time(), 6), **out})
        return out


# ---------------- config-level construction ----------------


def _engine_layout(base: ServeLayout, overlay: dict) -> ServeLayout:
    kw = {}
    for k in ("rows", "row_tokens", "max_segments_per_row",
              "min_px", "max_px"):
        v = overlay.get(k)
        if v is not None:
            kw[k] = int(v)
    return dataclasses.replace(base, **kw) if kw else base


def build_serve_fleet(cfg, state_dict: dict | None = None, *,
                      ckpt_dir: str | None = None, device="cuda",
                      seed: int = 0, warn: bool = True, observer=None):
    """The config-level fleet entry: one restore (``state_dict``,
    ``ckpt_dir`` or a seeded init, ``weights.py``), at most one int8
    model of it, shared by every int8 engine (``serve.quant``), N engines
    from the ``serve.fleet.engines`` overlays (none: one default engine),
    and the content-addressed cache in front (``serve.cache``), on
    ``device``.

    The int8 model's CLS drift against the bf16 one is measured at build
    (``quant_feature_drift``) and fired through ``warn_quant_drift``
    against ``serve.quant.drift_tol``; the cache capacity through
    ``warn_cache_memory``. Returns the ``FleetRouter``, with the drift
    record as ``quant_drift`` (None without int8 engines)."""
    from dinov3_tpu_torch.configs.config import (
        serve_cache_wished,
        serve_quant_wished,
        warn_cache_memory,
        warn_quant_drift,
    )
    from dinov3_tpu_torch.serve.engine import (
        PackedServeEngine,
        serve_layout_from_cfg,
    )
    from dinov3_tpu_torch.serve.quant import (
        quant_feature_drift,
        quantize_serving_model,
    )
    from dinov3_tpu_torch.serve.weights import load_serving_model

    model = load_serving_model(cfg, state_dict, ckpt_dir=ckpt_dir,
                               device=device, seed=seed)
    base_layout = serve_layout_from_cfg(cfg)
    s = cfg.get("serve") or {}
    base_flush_ms = float(s.get("flush_ms", 10.0) or 10.0)
    ring_depth = int(s.get("ring_depth", 2) or 2)
    qcfg = s.get("quant") or {}
    default_quant = serve_quant_wished(cfg)
    tol = float(qcfg.get("drift_tol", 0.05) or 0.05)

    engines_cfg = (s.get("fleet") or {}).get("engines") or None
    if not engines_cfg:
        engines_cfg = [{"name": "default"}]

    qmodel = None
    drift = None
    specs = []
    for i, e in enumerate(engines_cfg):
        e = dict(e)
        name = str(e.get("name") or f"engine{i}")
        layout = _engine_layout(base_layout, e)
        use_quant = bool(e.get("quant", default_quant))
        served = model
        if use_quant:
            if qmodel is None:
                qmodel = quantize_serving_model(model)
                probe_px = int(qcfg.get("probe_px", 0) or 0)
                if probe_px <= 0:
                    p = base_layout.patch_size
                    probe_px = max(p, (min(base_layout.max_px, 224)
                                       // p) * p)
                drift = quant_feature_drift(model, qmodel, px=probe_px)
                if warn:
                    warn_quant_drift(
                        drift["cls_max_abs_diff"], tol=tol,
                        axis=f"int8 serving model, {probe_px}px CLS probe")
            served = qmodel
        slo = e.get("slo")
        if isinstance(slo, str):
            slo = tuple(c.strip() for c in slo.split(",") if c.strip())
        elif slo is not None:
            slo = tuple(str(c) for c in slo)
        eng = PackedServeEngine(
            served, layout,
            flush_ms=float(e.get("flush_ms", base_flush_ms)),
            ring_depth=ring_depth, warn=warn)
        specs.append(EngineSpec(name=name, engine=eng, slo_classes=slo))

    cache = None
    if serve_cache_wished(cfg):
        ccfg = s.get("cache") or {}
        capacity = int(ccfg.get("capacity", 4096) or 4096)
        if warn:
            warn_cache_memory(
                capacity, model.embed_dim,
                budget_mb=float(ccfg.get("host_budget_mb", 1024) or 1024))
        cache = FeatureCache(capacity)

    router = FleetRouter(specs, cache=cache, observer=observer)
    router.quant_drift = drift
    return router
