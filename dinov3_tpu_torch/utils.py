"""Parameter counts and loss recording/comparison (``dinov3_tpu/utils.py``).

Loss files are JSON lines, ``{"iteration": i, "<metric>": v, ...}``, the
JAX package's format: a file recorded by either package is read by the
other's ``LossComparator``.
"""

from __future__ import annotations

import json
import logging
from typing import Mapping

import torch

from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def count_parameters(module: torch.nn.Module) -> dict:
    """{top-level child: parameter count} plus a ``total`` entry."""
    out = {name: sum(p.numel() for p in child.parameters())
           for name, child in module.named_children()}
    out["total"] = sum(p.numel() for p in module.parameters())
    return out


def format_parameter_counts(counts: dict) -> str:
    width = max(len(k) for k in counts)
    return "\n".join(f"{k:<{width}}  {v / 1e6:10.2f} M" for k, v in counts.items())


class LossRecorder:
    """Append per-iteration scalar dicts to a JSON-lines file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def record(self, iteration: int, metrics: Mapping[str, float]) -> None:
        row = {"iteration": int(iteration)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class LossComparator:
    """Compare a run's losses against a recorded file, iteration by
    iteration, within ``atol + rtol * |recorded|``. ``check`` logs each
    divergence and returns whether the iteration matched; ``summary``
    reports the worst deviation."""

    def __init__(self, path: str, rtol: float = 1e-3, atol: float = 1e-4):
        self.rows = {}
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                self.rows[int(row.pop("iteration"))] = row
        self.rtol, self.atol = rtol, atol
        self.worst: tuple = (0.0, None, -1)  # (abs err, key, iteration)
        self.n_checked = 0
        self.n_diverged = 0

    def check(self, iteration: int, metrics: Mapping[str, float]) -> bool:
        ref = self.rows.get(int(iteration))
        if ref is None:
            return True
        self.n_checked += 1
        ok = True
        for key, want in ref.items():
            got = metrics.get(key)
            if got is None:
                continue
            err = abs(float(got) - want)
            if err > self.atol + self.rtol * abs(want):
                ok = False
                logger.warning("loss divergence at iter %d: %s = %.6g, "
                               "recorded %.6g", iteration, key, float(got), want)
            if err > self.worst[0]:
                self.worst = (err, key, iteration)
        self.n_diverged += not ok
        return ok

    def summary(self) -> str:
        err, key, it = self.worst
        head = f"compared {self.n_checked} iterations, {self.n_diverged} diverged"
        if key is None:
            return head + "; exact match"
        return head + f"; worst |err| {err:.3g} on {key!r} at iter {it}"
