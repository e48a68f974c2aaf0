"""Webdataset-style tar shards (``dinov3_tpu/data/datasets/web_shards.py``),
selected as ``WebShards:root=/data/lvd`` (optionally ``:pattern=...`` and
``:split=...``): ``shard-%06d.tar`` files of ``<key>.jpg`` / ``<key>.cls``
pairs, as web-scale corpora ship.

Random access over sequentially written shards: each shard's members are
indexed from its tar headers once, the index cached as ``<shard>.idx.npy``
beside it where the directory is writable (published atomically, reused
while newer than the shard), and samples are read as zero-copy slices of
memory-mapped shards, so the samplers work on it unchanged. Samples are
ordered by shard, then by key; a key with no ``.cls`` member has label
-1."""

from __future__ import annotations

import glob
import logging
import os
import tarfile
from typing import Callable, Optional

import numpy as np

from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset
from dinov3_tpu_torch.data.datasets.tar_backed import TarMmapCache
from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".webp"}
_INDEX_DTYPE = [
    ("shard", "<u4"),
    ("offset", "<u8"),       # payload offset of the image member
    ("size", "<u8"),
    ("label", "<i8"),        # -1 when the shard carries no .cls member
]


def _index_shard(path: str) -> list[tuple]:
    """[(key, offset, size, label)] of one shard, from its tar headers,
    sorted by key."""
    images: dict[str, tuple[int, int]] = {}
    labels: dict[str, int] = {}
    with tarfile.open(path, "r:") as tf:
        for member in tf:
            if not member.isfile():
                continue
            key, ext = os.path.splitext(member.name)
            ext = ext.lower()
            if ext in _IMAGE_EXTS:
                images[key] = (member.offset_data, member.size)
            elif ext == ".cls":
                payload = tf.extractfile(member).read()
                labels[key] = int(payload.decode().strip() or -1)
    return [(key, off, size, labels.get(key, -1))
            for key, (off, size) in sorted(images.items())]


class WebShards(ExtendedVisionDataset):
    """``root/<pattern>`` shards with random access. A split other than
    TRAIN reads ``root/<split>/`` and must have it (serving the training
    shards for a VAL request would score evals on training data); TRAIN
    reads ``root/train/`` where it exists, else ``root``."""

    def __init__(self, *, root: str, pattern: str = "*.tar", split: str = "TRAIN",
                 transform: Optional[Callable] = None,
                 target_transform: Optional[Callable] = None, seed: int = 0,
                 mmap_cache_size: int = 16):
        super().__init__(transform, target_transform, seed)
        split_dir = os.path.join(root, str(split).lower())
        if os.path.isdir(split_dir):
            root = split_dir
        elif str(split).upper() != "TRAIN":
            raise FileNotFoundError(
                f"split={split}: no shard directory {split_dir} "
                "(non-TRAIN splits need their own shards)")
        self.root = root
        self.shards = sorted(glob.glob(os.path.join(root, pattern)))
        if not self.shards:
            raise FileNotFoundError(f"no {pattern} shards under {root}")
        self._entries = self._build_index()
        self._mmaps = TarMmapCache(lambda i: self.shards[i],
                                   cache_size=int(mmap_cache_size))

    def _build_index(self) -> np.ndarray:
        rows = []
        for si, shard in enumerate(self.shards):
            idx_path = shard + ".idx.npy"
            if (os.path.exists(idx_path)
                    and os.path.getmtime(idx_path) >= os.path.getmtime(shard)):
                part = np.load(idx_path)
            else:
                part = np.array([(si, off, size, label)
                                 for _, off, size, label in _index_shard(shard)],
                                dtype=_INDEX_DTYPE)
                try:
                    # publish atomically: loader threads or processes may
                    # race on the cache (.npy suffix: np.save keeps the path)
                    tmp = f"{idx_path}.{os.getpid()}.tmp.npy"
                    np.save(tmp, part)
                    os.replace(tmp, idx_path)
                except OSError:
                    pass  # read-only storage: the index stays in memory
            part = part.copy()
            part["shard"] = si
            rows.append(part)
        entries = np.concatenate(rows)
        logger.info("WebShards: %d samples across %d shards under %s",
                    len(entries), len(self.shards), self.root)
        return entries

    def get_image_data(self, index: int) -> bytes:
        row = self._entries[index]
        return self._mmaps.read(row["shard"], row["offset"], row["size"])

    def get_target(self, index: int) -> int:
        return int(self._entries[index]["label"])

    def get_targets(self) -> np.ndarray:
        return self._entries["label"].astype(np.int64)

    def __len__(self) -> int:
        return len(self._entries)
