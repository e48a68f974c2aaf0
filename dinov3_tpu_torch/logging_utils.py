"""Logging and training meters (``dinov3_tpu/logging_utils.py``).

The port logs under its own logger, ``"dinov3_tpu_torch"``; the JAX
package's ``"dinov3"`` logger is never touched. ``setup_logging`` returns
the handlers it added so that a caller can take them off again.
``MetricLogger(tensorboard_dir=...)`` mirrors the meters to tensorboard
events through ``tensorboardX`` when it can be imported, else
``torch.utils.tensorboard``, else it logs a warning and keeps JSON lines
only.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Iterable

LOGGER_NAME = "dinov3_tpu_torch"
logger = logging.getLogger(LOGGER_NAME)


def setup_logging(output_dir: str | None = None) -> list[logging.Handler]:
    """Console and ``<output_dir>/log.txt`` logging on the port's logger.
    Returns the handlers added (none when the logger already has some)."""
    root = logging.getLogger(LOGGER_NAME)
    if root.handlers:
        return []
    root.setLevel(logging.INFO)
    root.propagate = False
    fmt = logging.Formatter(
        fmt="%(asctime)s %(levelname).1s %(name)s %(filename)s:%(lineno)d] "
            "%(message)s",
        datefmt="%Y%m%d %H:%M:%S",
    )
    added: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        added.append(logging.FileHandler(os.path.join(output_dir, "log.txt")))
    for h in added:
        h.setFormatter(fmt)
        root.addHandler(h)
    return added


def remove_handlers(handlers: Iterable[logging.Handler]) -> None:
    """Undo ``setup_logging``: detach and close the handlers it added."""
    root = logging.getLogger(LOGGER_NAME)
    for h in handlers:
        root.removeHandler(h)
        h.close()


class SmoothedValue:
    """Windowed median/avg meter."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, num: int = 1) -> None:
        self.deque.append(value)
        self.count += num
        self.total += value * num

    @property
    def median(self) -> float:
        if not self.deque:
            return 0.0
        d = sorted(self.deque)
        return d[len(d) // 2]

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    """Iteration driver printing smoothed meters and an ETA, dumping JSON
    lines to ``output_file``."""

    def __init__(self, delimiter: str = "  ", output_file: str | None = None,
                 tensorboard_dir: str | None = None):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.output_file = output_file
        self._tb = None
        if tensorboard_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None
            if SummaryWriter is None:
                logger.warning(
                    "tensorboard_dir=%s set but neither tensorboardX nor "
                    "torch.utils.tensorboard is importable (both are "
                    "optional dependencies); falling back to JSON-lines "
                    "only", tensorboard_dir)
            else:
                self._tb = SummaryWriter(log_dir=tensorboard_dir)

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def consume_flush(self, names, iterations, rows, scheds=None) -> None:
        """One flushed ring window (``telemetry/ring.py RingReader.flush``):
        one meter update a row, in iteration order, so the windowed
        medians see every step's exact value. ``scheds`` (``iteration ->
        dict``) merges the host-side schedule values into each row."""
        for j, it in enumerate(iterations):
            kwargs = dict(zip(names, (float(v) for v in rows[j])))
            if scheds is not None:
                kwargs.update(scheds(int(it)))
            self.update(**kwargs)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def dump_json(self, iteration: int, iter_time: float, data_time: float) -> None:
        if self._tb is not None:
            for k, m in self.meters.items():
                self._tb.add_scalar(k, m.median, iteration)
            self._tb.add_scalar("iter_time", iter_time, iteration)
        if not self.output_file:
            return
        entry = {"iteration": iteration, "iter_time": iter_time,
                 "data_time": data_time,
                 **{k: m.median for k, m in self.meters.items()}}
        with open(self.output_file, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def log_every(self, iterable: Iterable, print_freq: int = 10,
                  header: str = "", n_iterations: int | None = None,
                  start_iteration: int = 0):
        """Yields (iteration, item) from ``start_iteration`` until
        ``n_iterations``; every ``print_freq`` iterations (and at the last)
        logs the meters and dumps one JSON line."""
        i = start_iteration
        if n_iterations is None:
            try:
                n_iterations = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                n_iterations = None
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.perf_counter()
        for obj in iterable:
            data_time.update(time.perf_counter() - end)
            yield i, obj
            iter_time.update(time.perf_counter() - end)
            if i % print_freq == 0 or (n_iterations and i == n_iterations - 1):
                self.dump_json(i, iter_time.avg, data_time.avg)
                eta = ""
                if n_iterations:
                    secs = iter_time.global_avg * (n_iterations - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(secs))}  "
                meters = self.delimiter.join(
                    f"{name}: {meter}" for name, meter in self.meters.items())
                total = f"/{n_iterations}" if n_iterations else ""
                logger.info(f"{header} [{i}{total}]  {eta}{meters}  "
                            f"time: {iter_time}  data: {data_time}")
            i += 1
            end = time.perf_counter()
            if n_iterations and i >= n_iterations:
                break
