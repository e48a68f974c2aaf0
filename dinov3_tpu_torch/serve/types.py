"""Request/response types for the embedding-serving engine.

Plain dataclasses over host numpy — the serve frontend is host code
(batcher.py packs, engine.py dispatches); nothing here touches the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ServeRequest:
    """One image awaiting feature extraction.

    ``image``: [H, W, C] float32, H and W multiples of the model patch
    size (the loader owns resize/normalize — the engine serves exactly
    what the trainer's eval path would forward). ``arrival_s`` is the
    submit timestamp on whatever clock the caller replays (bench_serve
    uses a virtual clock so latency percentiles don't require real
    sleeps). ``slo`` is the service-class label the observability plane
    keys latency histograms on (telemetry/serve_obs.py) — free-form
    ("interactive", "batch", ...), never interpreted by the engine
    itself."""

    request_id: int
    image: np.ndarray
    arrival_s: float = 0.0
    slo: str = "default"

    @property
    def hw(self) -> tuple[int, int]:
        return int(self.image.shape[0]), int(self.image.shape[1])


@dataclasses.dataclass
class ServeResponse:
    """Features for one request: the CLS embedding and the mean-pooled
    patch embedding (both [D] float32 — the two feature views the eval
    harness and downstream retrieval consume)."""

    request_id: int
    cls_feature: np.ndarray
    pooled_patch_feature: np.ndarray
    n_patches: int
    # per-token patch features [n_patches, D] f32 — populated only by
    # engines built with ``patch_features=True`` (the serve-backed
    # distillation teacher consumes these for the iBOT loss); None on
    # the default CLS+pool serving path
    patch_tokens: np.ndarray | None = None
    arrival_s: float = 0.0
    done_s: float = 0.0
    slo: str = "default"
    # fleet provenance (serve/fleet.py FleetRouter): which pool engine
    # served the request ("" outside a fleet) and whether the features
    # came from the content-addressed cache (serve/cache.py) instead of
    # a forward — the per-request record the hit-rate sweep audits
    engine: str = ""
    cache_hit: bool = False

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s
