"""Read-only memory maps of tar files (``dinov3_tpu/data/datasets/tar_backed.py``),
shared by the tar-backed datasets (ImageNet-22k's per-class tarballs, web
shards): an LRU cache of maps, each read a zero-copy slice."""

from __future__ import annotations

import mmap
from functools import lru_cache
from typing import Callable


class TarMmapCache:
    """``read(tar_index, offset, size)`` over lazily opened, LRU-cached
    memory maps; ``path_for_index`` resolves a tar index to its path when
    the map is first opened. Safe under the loader's worker threads: an
    evicted map closes when its last reader drops it, and slicing a map
    only reads."""

    def __init__(self, path_for_index: Callable[[int], str], cache_size: int = 16):
        self._path_for_index = path_for_index
        self._get = lru_cache(maxsize=cache_size)(self._open)

    def _open(self, tar_index: int) -> mmap.mmap:
        with open(self._path_for_index(tar_index), "rb") as f:
            return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)

    def read(self, tar_index: int, offset: int, size: int) -> bytes:
        m = self._get(int(tar_index))
        return m[int(offset):int(offset) + int(size)]
