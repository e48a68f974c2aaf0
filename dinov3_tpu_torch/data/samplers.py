"""Index samplers (``dinov3_tpu/data/samplers.py``): deterministic,
striped across hosts (``start=rank, step=world``) and resumable through
``advance(n)``.
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


class EpochSampler:
    """Tile the dataset ``size`` to at least ``advance`` + one epoch, shuffle
    each epoch block with a per-epoch seed, stripe across hosts."""

    def __init__(
        self,
        size: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if size <= 0:
            raise ValueError(f"dataset size must be positive, got {size}")
        self.size = size
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self._start = 0

    def advance(self, n: int) -> None:
        """Skip the first n *global* samples (resume support)."""
        self._start += n

    def __iter__(self) -> Iterator[int]:
        epoch = self._start // self.size
        offset = self._start % self.size
        while True:
            order = np.arange(self.size)
            if self.shuffle:
                rng = np.random.default_rng((self.seed, epoch))
                rng.shuffle(order)
            block = order[offset:]
            # stripe by rank within the global stream
            for i in range(self.rank, len(block), self.world_size):
                yield int(block[i])
            epoch += 1
            offset = 0


class InfiniteSampler:
    """I.i.d. uniform index stream: no epoch structure, one PRNG stream
    striped across hosts."""

    def __init__(
        self,
        size: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if size <= 0:
            raise ValueError(f"dataset size must be positive, got {size}")
        self.size = size
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self._start = 0

    def advance(self, n: int) -> None:
        """Skip the first n *local* samples (resume support)."""
        self._start += n

    def _global_stream(self) -> Iterator[int]:
        if not self.shuffle:
            yield from itertools.cycle(range(self.size))
            return
        rng = np.random.default_rng(self.seed)
        while True:
            yield from rng.integers(0, self.size, 65536).tolist()

    def __iter__(self) -> Iterator[int]:
        it = self._global_stream()
        start = self.rank + self._start * self.world_size
        yield from itertools.islice(it, start, None, self.world_size)


class ShardedInfiniteSampler:
    """Infinite shuffled epochs where each host permutes only its own shard
    of the index space: O(size / world) memory per host and no cross-host
    coordination."""

    def __init__(
        self,
        size: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if size <= 0:
            raise ValueError(f"dataset size must be positive, got {size}")
        self.size = size
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self._start = 0  # local (per-host) sample count

    def advance(self, n: int) -> None:
        """Skip the first n *local* samples."""
        self._start += n

    def __iter__(self) -> Iterator[int]:
        shard = np.arange(self.rank, self.size, self.world_size)
        per_epoch = len(shard)
        if per_epoch == 0:
            return
        epoch = self._start // per_epoch
        offset = self._start % per_epoch
        while True:
            order = shard.copy()
            if self.shuffle:
                rng = np.random.default_rng((self.seed, self.rank, epoch))
                rng.shuffle(order)
            for i in order[offset:]:
                yield int(i)
            epoch += 1
            offset = 0
