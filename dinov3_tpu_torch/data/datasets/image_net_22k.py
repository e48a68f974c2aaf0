"""ImageNet-22k from per-class tarballs (``dinov3_tpu/data/datasets/
image_net_22k.py``), selected as ``ImageNet22k:root=/data/in22k``: one
``<wnid>.tar`` of raw images per class, the class index that of the tar in
sorted order.

The first use indexes every tar's members from its headers (class index,
tar index, payload offset and size, in member order) and caches the table
under ``extra/`` (default ``root/extra``) as ``entries-ALL.npy`` with the
tar names in ``tar-names-ALL.npy``; later uses read the cache. Samples are
zero-copy slices of memory-mapped tars."""

from __future__ import annotations

import os
import tarfile
from typing import Callable, Optional

import numpy as np

from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset
from dinov3_tpu_torch.data.datasets.tar_backed import TarMmapCache

_ENTRIES_DTYPE = [
    ("class_index", "<u4"),
    ("tar_index", "<u4"),
    ("offset", "<u8"),
    ("size", "<u8"),
]


class ImageNet22k(ExtendedVisionDataset):
    def __init__(self, *, root: str, extra: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None, seed: int = 0,
                 mmap_cache_size: int = 16):
        super().__init__(transform, target_transform, seed)
        self.root = root
        self.extra = extra or os.path.join(root, "extra")
        self._entries: np.ndarray | None = None
        self._tar_names: list[str] | None = None
        self._mmaps = TarMmapCache(
            lambda i: os.path.join(self.root, str(self._tar_names[i])),
            cache_size=int(mmap_cache_size))

    @property
    def _entries_path(self) -> str:
        return os.path.join(self.extra, "entries-ALL.npy")

    @property
    def _tars_path(self) -> str:
        return os.path.join(self.extra, "tar-names-ALL.npy")

    def _build_entries(self) -> np.ndarray:
        tars = sorted(f for f in os.listdir(self.root) if f.endswith(".tar"))
        if not tars:
            raise FileNotFoundError(f"no .tar class archives under {self.root}")
        rows = []
        for ti, tname in enumerate(tars):
            with tarfile.open(os.path.join(self.root, tname)) as tf:
                rows.extend((ti, ti, m.offset_data, m.size) for m in tf if m.isfile())
        entries = np.array(rows, dtype=_ENTRIES_DTYPE)
        os.makedirs(self.extra, exist_ok=True)
        np.save(self._entries_path, entries)
        np.save(self._tars_path, np.array(tars))
        return entries

    def _get_entries(self) -> np.ndarray:
        if self._entries is None:
            if not os.path.exists(self._entries_path):
                self._build_entries()
            self._entries = np.load(self._entries_path)
            self._tar_names = list(np.load(self._tars_path))
        return self._entries

    def get_image_data(self, index: int) -> bytes:
        e = self._get_entries()[index]
        return self._mmaps.read(e["tar_index"], e["offset"], e["size"])

    def get_target(self, index: int) -> int:
        return int(self._get_entries()[index]["class_index"])

    def get_targets(self) -> np.ndarray:
        return self._get_entries()["class_index"].astype(np.int64)

    def __len__(self) -> int:
        return len(self._get_entries())
