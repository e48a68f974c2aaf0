"""Run and serving telemetry (``dinov3_tpu/telemetry``).

- ``host_sync.py``: the counted device-to-host fetch funnel the serve
  engines read through (``blocking_fetch``, ``host_sync_stats``);
- ``hist.py``: fixed-memory log-bucketed latency histograms and the
  exact nearest-rank quantile;
- ``spans.py``: the JSONL span tracer with its heartbeat
  (``SpanTracer``), the phase vocabularies, and the trainer's
  ``--benchmark`` timer (``StepTimer``);
- ``watchdog.py``: role-namespaced heartbeats, their staleness scan and
  the flush-window stall span;
- ``serve_obs.py``: the serving observability plane (per-request phase
  spans, per-SLO latency histograms, the live-mix envelope);
- ``ring.py``: the trainer's on-device metrics ring, flushed once per
  ``telemetry.flush_every`` steps with one fetch, and its device-side
  non-finite streak (``telemetry.async_metrics=false`` keeps the
  one-read-a-step path as the oracle);
- ``memory.py``: the allocator's bytes in use and peak, and a train
  state's bytes by part;
- ``trace.py`` and ``anatomy.py``: the ``--profile-steps`` window's
  ``torch.profiler`` trace read into per-device timelines, and the
  per-step anatomy ledger (device ms by kernel category and named scope,
  the backward interval, measured collective overlap) with the fleet
  report over the span streams.
"""

from dinov3_tpu_torch.telemetry.anatomy import (
    CATEGORIES,
    anatomy_ledger,
    categorize,
    emit_step_anatomy,
    events_by_step,
    fleet_report,
    ledger_summary,
    load_span_streams,
)
from dinov3_tpu_torch.telemetry.hist import LogHistogram, quantile_nearest_rank
from dinov3_tpu_torch.telemetry.host_sync import blocking_fetch, host_sync_stats
from dinov3_tpu_torch.telemetry.memory import per_device_state_bytes, sample_memory
from dinov3_tpu_torch.telemetry.ring import RingReader, RingState, make_ring, write_row
from dinov3_tpu_torch.telemetry.serve_obs import (
    LiveMixTracker,
    ServeObserver,
    recommended_serve_envelope,
    simulated_ffd_waste,
)
from dinov3_tpu_torch.telemetry.spans import (
    PHASES,
    SERVE_PHASES,
    SPAN_SCHEMA_V,
    SpanTracer,
    StepTimer,
)
from dinov3_tpu_torch.telemetry.trace import Trace, TraceEvent, find_trace_file, load_trace
from dinov3_tpu_torch.telemetry.watchdog import (
    Watchdog,
    heartbeat_path,
    read_heartbeat,
    scan_heartbeats,
)


def telemetry_wished(cfg) -> bool:
    """Whether the config asks for the metrics ring
    (``telemetry.async_metrics``: auto/true, the default, = the ring;
    false = the one-read-a-step oracle)."""
    t = (cfg.get("telemetry") or {}).get("async_metrics", "auto")
    if isinstance(t, str):
        return t.lower() in ("auto", "true", "on")
    return bool(t)


__all__ = [
    "CATEGORIES", "RingReader", "RingState", "Trace", "TraceEvent",
    "anatomy_ledger", "categorize", "emit_step_anatomy", "events_by_step",
    "find_trace_file",
    "fleet_report", "ledger_summary", "load_span_streams", "load_trace",
    "make_ring", "per_device_state_bytes", "sample_memory", "telemetry_wished",
    "write_row",
    "LiveMixTracker", "LogHistogram", "PHASES", "SERVE_PHASES",
    "SPAN_SCHEMA_V", "ServeObserver", "SpanTracer", "StepTimer", "Watchdog",
    "blocking_fetch", "heartbeat_path", "host_sync_stats",
    "quantile_nearest_rank", "read_heartbeat", "recommended_serve_envelope",
    "scan_heartbeats", "simulated_ffd_waste",
]
