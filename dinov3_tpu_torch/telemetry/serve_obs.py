"""Serving observability plane (``dinov3_tpu/telemetry/serve_obs.py``):
per-request spans, SLO histograms, live-mix envelopes.

- **per-request spans**: every request carries an id and an SLO class
  (``serve/types.py``); ``ServeObserver.on_pack`` emits one
  ``serve_request`` record per response with the six phase durations
  (``enqueue -> pack_placement -> dispatch -> device -> fetch ->
  extract``, ``spans.py SERVE_PHASES``) plus per-pack phase spans,
  through the ``SpanTracer`` JSONL schema. ``device`` and ``fetch`` are
  one phase on the host's clock: the engine's one device-to-host read
  (``host_sync.blocking_fetch``) fences the device work, and a separate
  fence would be another blocking sync, which this plane must not add.
  ``device_ms`` runs from the return of dispatch to the return of the
  fetch, ``fetch_ms`` is the blocked part inside the fetch; they differ
  only when the host works between the two.
- **one-fetch serve stats**: the packed engine's per-pack stats row
  (token occupancy, segment count, pad tokens, pack stamp,
  ``serve/engine.py ServeRing.stats``) rides the same fetch as the
  features; the observer records it beside the host's plan values.
- **streaming SLO histograms** (``hist.py``): per-SLO-class log-bucketed
  latency histograms give live p50/p99 at fixed memory, serialized into
  ``serve_hist`` records at ``finalize()``.
- **live mix and envelope**: ``LiveMixTracker`` keeps an EWMA of the
  observed resolution mix and the measured pad waste per window;
  ``recommended_serve_envelope()`` re-derives rows, row tokens and segment
  slots by simulating the FFD batcher over the EWMA mix, and
  ``check_drift`` re-fires ``warn_serve_pad_waste`` when the live mix
  leaves the build-time envelope. The fleet (``serve/fleet.py``) derives
  its fast lane from it.

The fleet reports through the same observer: ``on_route`` counts
admission decisions per (engine, SLO) and ``on_cache`` counts and emits
``serve_cache`` records for the feature cache's hit/miss/insert/evict
events (a hit never reaches a pack, so that record is its trace).

Every ``window_packs`` packs the observer rolls the mix window into the
EWMA, beats the serve heartbeat (``heartbeat.serve``), flushes the span
stream and emits a ``serve_window`` record; a window whose wall time
outlasts its deadline emits a ``stall`` span.
"""

from __future__ import annotations

import math
import time

from dinov3_tpu_torch.telemetry.hist import LogHistogram
from dinov3_tpu_torch.telemetry.watchdog import Watchdog

# ---------------- live-mix tracking + envelope re-derivation ----------------


def _waste_single(seq_len: int, row_tokens: int) -> float:
    """Per-row pad waste of single-resolution traffic (the
    serve_pad_waste_floor form, configs/config.py)."""
    if seq_len > row_tokens:
        return 1.0
    return 1.0 - (row_tokens // seq_len) * seq_len / row_tokens


def simulated_ffd_waste(lens: list[int], row_tokens: int,
                        max_segments: int) -> float:
    """Pack a seq-len sample with first-fit-decreasing into unbounded
    rows of ``row_tokens`` capacity and ``max_segments`` slots; return
    the packed pad-waste fraction. This is the MIX-level estimator the
    envelope re-derivation uses — averaging single-resolution floors
    over a mix is badly pessimistic (FFD fills one resolution's row
    remainders with another's small images), while this reproduces the
    batcher's own placement rule (serve/batcher.py next_pack) on a
    synthetic drain."""
    if not lens:
        return 0.0
    fill: list[int] = []
    segs: list[int] = []
    for L in sorted(lens, reverse=True):
        if L > row_tokens:
            return 1.0  # inadmissible under this envelope
        for r in range(len(fill)):
            if fill[r] + L <= row_tokens and segs[r] < max_segments:
                fill[r] += L
                segs[r] += 1
                break
        else:
            fill.append(L)
            segs.append(1)
    return 1.0 - sum(fill) / (len(fill) * row_tokens)


def recommended_serve_envelope(seq_len_weights: dict, layout,
                               threshold: float = 0.15,
                               max_multiple: int = 4,
                               n_sample: int = 256) -> dict | None:
    """Re-derive the serve envelope from an observed seq-len mix.

    ``seq_len_weights``: {seq_len: weight} (the LiveMixTracker EWMA).
    Searches row_tokens over multiples of the largest observed seq len
    (m = 1..max_multiple — bigger bins pack tighter, O(N^2) attention
    caps how big, the serve.row_tokens=auto rationale) and keeps the
    SMALLEST row whose simulated-FFD mix waste is within ``threshold``
    (falling back to the argmin when none is). Returns the envelope the
    engine-pool admission layer re-keys ``warn_serve_pad_waste`` on:
    ``{min_seq_len, max_seq_len, row_tokens, rows,
    max_segments_per_row, expected_waste, within_threshold,
    threshold}`` — px bounds ride along when the tracker observed
    them. None when nothing was observed."""
    weights = {int(k): float(v) for k, v in seq_len_weights.items() if v > 0}
    if not weights:
        return None
    total = sum(weights.values())
    lens: list[int] = []
    for L, w in sorted(weights.items()):
        lens.extend([L] * max(1, round(w / total * n_sample)))
    l_max, l_min = max(weights), min(weights)
    best = None
    for m in range(1, max(1, int(max_multiple)) + 1):
        rt = m * l_max
        seg_cap = max(1, min(rt // l_min, 64))
        waste = simulated_ffd_waste(lens, rt, seg_cap)
        cand = {
            "row_tokens": rt,
            "rows": max(1, round(layout.token_budget / rt)),
            "max_segments_per_row": seg_cap,
            "expected_waste": round(waste, 4),
            "within_threshold": waste <= threshold,
        }
        if waste <= threshold:
            best = cand
            break
        if best is None or waste < best["expected_waste"]:
            best = cand
    best.update({
        "min_seq_len": l_min, "max_seq_len": l_max,
        "threshold": threshold,
    })
    return best


class LiveMixTracker:
    """EWMA of the observed resolution mix and measured pad waste.

    Per-window accumulation (requests' seq lens + px extents, packs'
    token occupancy) folds into the EWMA at ``roll()`` with weight
    ``alpha`` on the newest window — the live-mix signal
    ``check_drift`` compares against the build-time envelope and
    ``recommended_serve_envelope`` re-derives from."""

    def __init__(self, layout, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"mix EWMA alpha must be in (0, 1], got {alpha}")
        self.layout = layout
        self.alpha = float(alpha)
        self.windows = 0
        self.ewma_lens: dict[int, float] = {}
        self.ewma_pad_waste: float | None = None
        self.px_lo = math.inf
        self.px_hi = -math.inf
        self._win_lens: dict[int, int] = {}
        self._win_used = 0
        self._win_budget = 0

    def observe_request(self, seq_len: int, h_px: int = 0,
                        w_px: int = 0) -> None:
        L = int(seq_len)
        self._win_lens[L] = self._win_lens.get(L, 0) + 1
        for px in (h_px, w_px):
            if px:
                self.px_lo = min(self.px_lo, int(px))
                self.px_hi = max(self.px_hi, int(px))

    def observe_pack(self, tokens_used: int, token_budget: int) -> None:
        self._win_used += int(tokens_used)
        self._win_budget += int(token_budget)

    def roll(self) -> dict | None:
        """Fold the window into the EWMA; returns the window summary
        (None when the window saw nothing)."""
        if not self._win_lens and not self._win_budget:
            return None
        n = sum(self._win_lens.values())
        win_mix = {L: c / n for L, c in self._win_lens.items()} if n else {}
        a = self.alpha if self.windows else 1.0
        if win_mix:
            keys = set(self.ewma_lens) | set(win_mix)
            self.ewma_lens = {
                L: (1 - a) * self.ewma_lens.get(L, 0.0)
                   + a * win_mix.get(L, 0.0)
                for L in keys}
        win_waste = (1.0 - self._win_used / self._win_budget
                     if self._win_budget else None)
        if win_waste is not None:
            self.ewma_pad_waste = (
                win_waste if self.ewma_pad_waste is None
                else (1 - a) * self.ewma_pad_waste + a * win_waste)
        out = {
            "n_requests": n,
            "pad_waste": None if win_waste is None else round(win_waste, 4),
            "ewma_pad_waste": (None if self.ewma_pad_waste is None
                               else round(self.ewma_pad_waste, 4)),
            "distinct_seq_lens": len(win_mix),
        }
        self.windows += 1
        self._win_lens = {}
        self._win_used = 0
        self._win_budget = 0
        return out

    def recommended_serve_envelope(self, threshold: float = 0.15,
                                   max_multiple: int = 4) -> dict | None:
        env = recommended_serve_envelope(
            self.ewma_lens, self.layout, threshold=threshold,
            max_multiple=max_multiple)
        if env is not None and math.isfinite(self.px_lo):
            env["min_px"] = int(self.px_lo)
            env["max_px"] = int(self.px_hi)
        return env

    def check_drift(self, threshold: float = 0.15, warn: bool = True,
                    stacklevel: int = 2) -> str | None:
        """Re-fire ``warn_serve_pad_waste`` when the live-mix EWMA pad
        waste exceeds the threshold — the build-time envelope promised
        better, so either the traffic drifted or the envelope was wrong
        for it; ``recommended_serve_envelope()`` is the re-derived fix.
        Returns the warning message (None = silent / no data)."""
        if self.ewma_pad_waste is None:
            return None
        from dinov3_tpu_torch.configs.config import warn_serve_pad_waste

        axis = (f"live mix EWMA (alpha={self.alpha}, "
                f"{self.windows} windows) vs the build-time envelope")
        if warn:
            return warn_serve_pad_waste(
                self.ewma_pad_waste, threshold=threshold,
                stacklevel=stacklevel + 1, axis=axis)
        if self.ewma_pad_waste <= threshold:
            return None
        return f"serve pad-waste axis [{axis}]: {self.ewma_pad_waste:.1%}"


# ---------------- the observer ----------------


class ServeObserver:
    """Per-request spans + SLO histograms + live-mix windows, fed by
    the serve engines' hooks (serve/engine.py threads one of these
    behind ``telemetry.serve_spans``).

    Hooks, in request order: ``on_admit`` (request id, SLO class, seq
    len) -> ``on_pack`` (the pack's placements, measured phase
    durations, device-side stats row) -> ``observe_latency`` (the
    caller's end-to-end latency on ITS clock — the rated replay's
    virtual clock in serve/bench.py, so histograms match the
    exact-sample percentiles they replace). ``finalize()`` serializes
    the histograms and the mix EWMA into the span stream."""

    def __init__(self, tracer, layout, slo_classes=("default",),
                 window_packs: int = 16, hist_lo_ms: float = 1e-2,
                 hist_hi_ms: float = 1e5, bins_per_decade: int = 16,
                 mix_alpha: float = 0.25, window_deadline_s: float = 0.0,
                 warn_threshold: float = 0.15, warn: bool = True):
        self.tracer = tracer
        self.layout = layout
        self.window_packs = max(1, int(window_packs))
        self._hist_cfg = (float(hist_lo_ms), float(hist_hi_ms),
                          int(bins_per_decade))
        self.hists: dict[str, LogHistogram] = {
            str(c): self._new_hist() for c in slo_classes}
        self.mix = LiveMixTracker(layout, alpha=mix_alpha)
        self.watchdog = Watchdog(tracer, deadline_s=window_deadline_s)
        self.warn_threshold = float(warn_threshold)
        self.warn = bool(warn)
        self.labels: dict = {}
        self.packs = 0
        self.requests = 0
        # fleet-plane counters: the FleetRouter
        # (serve/fleet.py) reports cache hit/miss/insert/evict events
        # and per-(engine, SLO) route decisions here, so the one span
        # stream carries the admission layer's story next to the
        # per-request phase spans
        self.cache_events: dict[str, int] = {}
        self.route_counts: dict[str, int] = {}
        self._pending: dict[int, tuple[str, float]] = {}
        self._window_t0 = time.perf_counter()

    def _new_hist(self) -> LogHistogram:
        lo, hi, bpd = self._hist_cfg
        return LogHistogram(lo, hi, bins_per_decade=bpd)

    def hist(self, slo: str) -> LogHistogram:
        h = self.hists.get(str(slo))
        if h is None:
            h = self.hists[str(slo)] = self._new_hist()
        return h

    def set_labels(self, **labels) -> None:
        """Attach context labels (arm/mix/phase in bench_serve.py) to
        every subsequent record."""
        self.labels = {k: v for k, v in labels.items() if v is not None}

    def emit(self, record: dict) -> None:
        if self.tracer is not None:
            self.tracer.emit({**record, **self.labels})

    # ---- request lifecycle ----

    def on_admit(self, request_id: int, slo: str, seq_len: int,
                 h_px: int = 0, w_px: int = 0) -> None:
        self._pending[int(request_id)] = (str(slo), time.perf_counter())
        self.mix.observe_request(seq_len, h_px, w_px)

    def on_pack(self, placements, phases_ms: dict,
                device_stats: dict | None = None,
                tokens_used: int | None = None,
                token_budget: int | None = None) -> None:
        """One executed pack: ``placements`` is a list of
        ``(request_id, slo, seq_len)``; ``phases_ms`` the measured
        ``{placement, dispatch, device, fetch, extract}`` durations;
        ``device_stats`` the ring-fetched stats row (None on the oracle
        arms — they have no packed plane). ``token_budget`` defaults to
        the packed layout's fixed budget; the oracle arms pass their
        per-flush padded total instead."""
        pack = self.packs
        self.packs += 1
        t = round(time.time(), 6)
        for span_name, key in (("pack_placement", "placement"),
                               ("dispatch", "dispatch"),
                               ("device", "device"), ("fetch", "fetch"),
                               ("extract", "extract")):
            if phases_ms.get(key) is not None:
                self.emit({"name": f"serve_{span_name}", "pack": pack,
                           "t": t,
                           "dur_ms": round(float(phases_ms[key]), 4),
                           "n_requests": len(placements)})
        if device_stats is not None:
            self.emit({"name": "serve_pack_stats", "pack": pack, "t": t,
                       **{k: v for k, v in device_stats.items()},
                       "host_tokens_used": tokens_used,
                       "host_segments": len(placements)})
        now_perf = time.perf_counter()
        for rid, slo, seq_len in placements:
            pending = self._pending.pop(int(rid), None)
            enq_ms = None
            if pending is not None:
                slo = pending[0]
                # queue wait ends where placement began
                enq_ms = max(0.0, (now_perf - pending[1]) * 1e3
                             - sum(float(phases_ms.get(k) or 0.0)
                                   for k in ("placement", "dispatch",
                                             "device", "extract")))
            self.requests += 1

            def ms(key):
                v = phases_ms.get(key)
                return None if v is None else round(float(v), 4)

            self.emit({
                "name": "serve_request", "rid": int(rid), "slo": str(slo),
                "pack": pack, "t": t, "seq_len": int(seq_len),
                "enqueue_ms": None if enq_ms is None else round(enq_ms, 4),
                "pack_placement_ms": ms("placement"),
                "dispatch_ms": ms("dispatch"),
                "device_ms": ms("device"),
                "fetch_ms": ms("fetch"),
                "extract_ms": ms("extract"),
            })
        if tokens_used is not None:
            self.mix.observe_pack(
                tokens_used,
                self.layout.token_budget if token_budget is None
                else token_budget)
        if self.packs % self.window_packs == 0:
            self.roll_window()

    def on_route(self, engine: str, slo: str) -> None:
        """One admission decision (serve/fleet.py FleetRouter.route):
        counted per "engine/slo" — the route mix the fleet bench record
        embeds (serve/bench.py _fleet_summary)."""
        key = f"{engine}/{slo}"
        self.route_counts[key] = self.route_counts.get(key, 0) + 1

    def on_cache(self, event: str, request_id: int | None = None,
                 slo: str | None = None, engine: str | None = None) -> None:
        """One feature-cache event (``hit``/``miss``/``insert``/
        ``evict``, serve/cache.py): counted, and emitted as a
        ``serve_cache`` record so cache behaviour lands in the span
        stream per request (hits carry the rid that never reached a
        pack — their only per-request record)."""
        event = str(event)
        self.cache_events[event] = self.cache_events.get(event, 0) + 1
        self.emit({"name": "serve_cache", "event": event,
                   "rid": None if request_id is None else int(request_id),
                   "slo": slo, "engine": engine,
                   "t": round(time.time(), 6)})

    def observe_latency(self, slo: str, latency_s: float,
                        request_id: int | None = None) -> None:
        """End-to-end latency on the CALLER's clock (virtual in the
        rated replay) -> the SLO class's streaming histogram + one
        ``serve_latency`` record (the exact sample obs_report's
        agreement census reads)."""
        lat_ms = float(latency_s) * 1e3
        self.hist(slo).observe(lat_ms)
        self.emit({"name": "serve_latency", "slo": str(slo),
                   "rid": request_id, "lat_ms": round(lat_ms, 4)})

    # ---- windows ----

    def roll_window(self) -> dict | None:
        """Roll the mix window into the EWMA, beat the serve heartbeat,
        flush spans, fire the drift check; emits a ``serve_window``
        record. The watchdog stall-checks the window's wall time."""
        dur = time.perf_counter() - self._window_t0
        self._window_t0 = time.perf_counter()
        win = self.mix.roll()
        if win is None:
            return None
        drift = self.mix.check_drift(
            threshold=self.warn_threshold, warn=self.warn, stacklevel=3)
        win.update({"name": "serve_window", "pack": self.packs,
                    "t": round(time.time(), 6),
                    "dur_ms": round(dur * 1e3, 4),
                    "drift_warning": bool(drift)})
        self.emit(win)
        if self.watchdog.deadline_s > 0 and dur > self.watchdog.deadline_s:
            self.watchdog.stalls += 1
            self.emit({"name": "stall", "window": "serve_window",
                       "t": round(time.time(), 6),
                       "dur_ms": round(dur * 1e3, 4),
                       "deadline_ms": round(
                           self.watchdog.deadline_s * 1e3, 4)})
        if self.tracer is not None:
            self.tracer.beat(self.packs)
        return win

    # ---- teardown ----

    def finalize(self) -> dict:
        """Flush the trailing window and serialize the instruments:
        one ``serve_hist`` record per SLO class (full mergeable
        histogram state) + one ``serve_mix`` record (EWMA mix, measured
        waste, the re-derived envelope). Returns the summary dict
        serve/bench.py embeds."""
        self.roll_window()
        out = {"packs": self.packs, "requests": self.requests,
               "windows": self.mix.windows,
               "stalls": self.watchdog.stalls, "slo": {}}
        for slo, h in sorted(self.hists.items()):
            if h.total:
                self.emit({"name": "serve_hist", "slo": slo,
                           "t": round(time.time(), 6), "hist": h.to_dict()})
            out["slo"][slo] = h.summary()
        env = self.mix.recommended_serve_envelope(
            threshold=self.warn_threshold)
        mix_rec = {
            "name": "serve_mix", "t": round(time.time(), 6),
            "ewma_pad_waste": self.mix.ewma_pad_waste,
            "ewma_lens": {str(k): round(v, 6)
                          for k, v in sorted(self.mix.ewma_lens.items())},
            "recommended_envelope": env,
        }
        self.emit(mix_rec)
        out["ewma_pad_waste"] = self.mix.ewma_pad_waste
        out["recommended_envelope"] = env
        if self.cache_events:
            out["cache_events"] = dict(sorted(self.cache_events.items()))
        if self.route_counts:
            out["route_counts"] = dict(sorted(self.route_counts.items()))
        if self.tracer is not None:
            self.tracer.beat(self.packs)
        return out
