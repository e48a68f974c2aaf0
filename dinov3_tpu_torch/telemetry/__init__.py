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
  spans, per-SLO latency histograms, the live-mix envelope).

What waits (ROADMAP M11): the trainer's phase spans on ``SpanTracer``,
the device metrics ring, memory accounting, and the trace and step-anatomy
plane on ``torch.profiler``.
"""

from dinov3_tpu_torch.telemetry.hist import LogHistogram, quantile_nearest_rank
from dinov3_tpu_torch.telemetry.host_sync import blocking_fetch, host_sync_stats
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
from dinov3_tpu_torch.telemetry.watchdog import (
    Watchdog,
    heartbeat_path,
    read_heartbeat,
    scan_heartbeats,
)

__all__ = [
    "LiveMixTracker", "LogHistogram", "PHASES", "SERVE_PHASES",
    "SPAN_SCHEMA_V", "ServeObserver", "SpanTracer", "StepTimer", "Watchdog",
    "blocking_fetch", "heartbeat_path", "host_sync_stats",
    "quantile_nearest_rank", "read_heartbeat", "recommended_serve_envelope",
    "scan_heartbeats", "simulated_ffd_waste",
]
