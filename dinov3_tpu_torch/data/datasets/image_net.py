"""ImageNet from a local directory tree (``dinov3_tpu/data/datasets/
image_net.py``), selected as ``ImageNet:split=TRAIN:root=/data/in1k``
(or by ``data.root``).

The tree is the standard ``root/<split>/<wnid>/<file>`` one (split
``train``, ``val`` or ``test``). The first use of a split scans it, class
ids (wnids) sorted and files sorted within each class, and caches the
index under ``extra/`` (default ``root/extra``) as
``entries-<SPLIT>.npy`` (actual index, class index, relative path) and
``class-ids-<SPLIT>.npy``; later uses read the cache. ``Split.length``
holds the published split lengths. Local files only: nothing is
downloaded."""

from __future__ import annotations

import logging
import os
from enum import Enum
from typing import Callable, Optional

import numpy as np

from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset
from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)

_ENTRIES_DTYPE = [
    ("actual_index", "<u4"),
    ("class_index", "<u4"),
    ("relpath", "U255"),
]


class _Split(Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"

    @property
    def length(self) -> int:
        return {_Split.TRAIN: 1_281_167, _Split.VAL: 50_000,
                _Split.TEST: 100_000}[self]


class ImageNet(ExtendedVisionDataset):
    Split = _Split

    def __init__(
        self,
        *,
        split: "ImageNet.Split",
        root: str,
        extra: Optional[str] = None,
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
        seed: int = 0,
    ) -> None:
        super().__init__(transform, target_transform, seed)
        if isinstance(split, str):
            split = _Split[split]
        self.split = split
        self.root = root
        self.extra = extra or os.path.join(root, "extra")
        self._entries: np.ndarray | None = None
        self._class_ids: list[str] | None = None

    # ---------------------------------------------------------- index

    @property
    def _entries_path(self) -> str:
        return os.path.join(self.extra, f"entries-{self.split.value.upper()}.npy")

    @property
    def _class_ids_path(self) -> str:
        return os.path.join(self.extra, f"class-ids-{self.split.value.upper()}.npy")

    def _build_entries(self) -> np.ndarray:
        split_dir = os.path.join(self.root, self.split.value)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"ImageNet split directory not found: {split_dir}")
        class_ids = sorted(d for d in os.listdir(split_dir)
                           if os.path.isdir(os.path.join(split_dir, d)))
        rows = []
        for ci, wnid in enumerate(class_ids):
            for fname in sorted(os.listdir(os.path.join(split_dir, wnid))):
                rows.append((len(rows), ci, os.path.join(self.split.value, wnid, fname)))
        entries = np.array(rows, dtype=_ENTRIES_DTYPE)
        os.makedirs(self.extra, exist_ok=True)
        np.save(self._entries_path, entries)
        np.save(self._class_ids_path, np.array(class_ids))
        logger.info("built ImageNet index: %d entries, %d classes",
                    len(entries), len(class_ids))
        return entries

    def _get_entries(self) -> np.ndarray:
        if self._entries is None:
            if os.path.exists(self._entries_path):
                self._entries = np.load(self._entries_path)
            else:
                self._entries = self._build_entries()
        return self._entries

    def get_class_ids(self) -> list[str]:
        if self._class_ids is None:
            self._class_ids = list(np.load(self._class_ids_path))
        return self._class_ids

    # ------------------------------------------------------------ data

    def get_image_data(self, index: int) -> bytes:
        entry = self._get_entries()[index]
        with open(os.path.join(self.root, str(entry["relpath"])), "rb") as f:
            return f.read()

    def get_target(self, index: int) -> int:
        return int(self._get_entries()[index]["class_index"])

    def get_targets(self) -> np.ndarray:
        return self._get_entries()["class_index"].astype(np.int64)

    def __len__(self) -> int:
        return len(self._get_entries())
