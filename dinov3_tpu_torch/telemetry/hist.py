"""Streaming log-bucketed latency histograms and the exact-quantile
helper (``dinov3_tpu/telemetry/hist.py``; numpy and math only, a copy).

``LogHistogram`` is the fixed-memory percentile instrument of the serve
observability plane (``serve_obs.py``): observations land in log-spaced
buckets (``bins_per_decade`` per decade over ``[lo, hi)``, plus underflow
and overflow), so live p50/p99 never retain samples, and two histograms
merge by adding counts.

The quantile estimate is nearest-rank over bucket counts, reported at the
owning bucket's geometric midpoint, so estimate and exact sample quantile
sit in the same bucket: their ratio is within ``width_factor`` =
10^(1/bins_per_decade) (1.155 at the default 16). Observations out of
range count in the underflow/overflow buckets, and quantiles falling
there report the tracked exact min/max.

``quantile_nearest_rank`` is the exact-sample twin, the ceil(q*n)-th
order statistic, shared by the serving bench (``serve/bench.py``) and the
histogram-vs-exact checks.
"""

from __future__ import annotations

import math

import numpy as np


def quantile_nearest_rank(sorted_vals, q: float):
    """The exact nearest-rank quantile: the ceil(q*n)-th order statistic
    (1-indexed) of an ascending-sorted sequence — numpy's
    ``inverted_cdf`` method, without materializing through np.quantile's
    float path. q=0 returns the min, q=1 the max."""
    n = len(sorted_vals)
    if not n:
        raise ValueError("quantile of an empty sample")
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q={q} outside [0, 1]")
    k = max(1, math.ceil(q * n))
    return sorted_vals[min(k, n) - 1]


class LogHistogram:
    """Fixed-memory mergeable histogram over log-spaced buckets."""

    def __init__(self, lo: float = 1e-2, hi: float = 1e5,
                 bins_per_decade: int = 16):
        if not (lo > 0 and hi > lo):
            raise ValueError(f"need 0 < lo < hi, got [{lo}, {hi})")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bpd = int(bins_per_decade)
        if self.bpd < 1:
            raise ValueError(f"bins_per_decade must be >= 1, got {self.bpd}")
        self.n_bins = int(math.ceil(
            round(math.log10(self.hi / self.lo), 12) * self.bpd))
        # counts[0] = underflow (x < lo, incl. x <= 0), counts[-1] =
        # overflow (x >= hi); fixed allocation, never grows
        self.counts = np.zeros(self.n_bins + 2, np.int64)
        self.total = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ---- geometry ----

    @property
    def width_factor(self) -> float:
        """Multiplicative width of one bucket — the quantile error bound
        as a ratio (docstring above)."""
        return 10.0 ** (1.0 / self.bpd)

    def _edges(self, b: int) -> tuple[float, float]:
        """[lo, hi) edges of in-range bucket b (0-based)."""
        return (self.lo * 10.0 ** (b / self.bpd),
                self.lo * 10.0 ** ((b + 1) / self.bpd))

    # ---- observation ----

    def observe(self, x: float) -> None:
        self.observe_many(np.asarray([x], np.float64))

    def observe_many(self, xs) -> None:
        """Vectorized ingest of many observations at once."""
        xs = np.asarray(xs, np.float64).ravel()
        if not xs.size:
            return
        idx = np.zeros(xs.shape, np.int64)
        pos = xs > 0
        with np.errstate(divide="ignore"):
            b = np.floor(np.log10(np.where(pos, xs, 1.0) / self.lo)
                         * self.bpd).astype(np.int64)
        idx[pos] = np.clip(b[pos] + 1, 0, self.n_bins + 1)
        np.add.at(self.counts, idx, 1)
        self.total += int(xs.size)
        self.sum += float(xs.sum())
        self.min = min(self.min, float(xs.min()))
        self.max = max(self.max, float(xs.max()))

    # ---- readout ----

    @property
    def mean(self) -> float | None:
        return self.sum / self.total if self.total else None

    def quantile(self, q: float) -> float | None:
        """Nearest-rank quantile estimate at the owning bucket's
        geometric midpoint (None on an empty histogram)."""
        if not self.total:
            return None
        k = max(1, math.ceil(q * self.total))
        k = min(k, self.total)
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, k))
        if b == 0:
            return self.min          # underflow: exact tracked min
        if b == self.n_bins + 1:
            return self.max          # overflow: exact tracked max
        e0, e1 = self._edges(b - 1)
        return math.sqrt(e0 * e1)

    # ---- merge / serialization ----

    def _compatible(self, other: "LogHistogram") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.bpd == other.bpd)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Pure merge: a new histogram holding both sides' counts.
        Associative and commutative: window, rank and engine partials
        fold in any order."""
        if not self._compatible(other):
            raise ValueError(
                f"merging incompatible histograms: [{self.lo}, {self.hi})"
                f"x{self.bpd} vs [{other.lo}, {other.hi})x{other.bpd}")
        out = LogHistogram(self.lo, self.hi, self.bpd)
        out.counts = self.counts + other.counts
        out.total = self.total + other.total
        out.sum = self.sum + other.sum
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    def to_dict(self) -> dict:
        """JSON-ready state (span-stream ``serve_hist`` records;
        ``from_dict`` round-trips)."""
        nz = np.nonzero(self.counts)[0]
        return {
            "lo": self.lo, "hi": self.hi, "bins_per_decade": self.bpd,
            "total": int(self.total), "sum": self.sum,
            "min": None if self.total == 0 else self.min,
            "max": None if self.total == 0 else self.max,
            # sparse encoding: bucket index -> count (most latency
            # traffic occupies a handful of buckets)
            "buckets": {int(i): int(self.counts[i]) for i in nz},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        out = cls(d["lo"], d["hi"], d["bins_per_decade"])
        for i, c in d["buckets"].items():
            out.counts[int(i)] = int(c)
        out.total = int(d["total"])
        out.sum = float(d["sum"])
        out.min = math.inf if d["min"] is None else float(d["min"])
        out.max = -math.inf if d["max"] is None else float(d["max"])
        return out

    def summary(self, quantiles=(0.5, 0.99)) -> dict:
        out = {"n": self.total, "mean": self.mean,
               "width_factor": round(self.width_factor, 4)}
        for q in quantiles:
            v = self.quantile(q)
            out[f"p{round(q * 100):d}"] = v
        return out
