"""Content-addressed feature cache (``dinov3_tpu/serve/cache.py``).

Frozen weights and a deterministic forward make serving memoizable:
identical inputs give identical features, so repeated content
short-circuits to a host hit in front of the batcher. Keys are

    (engine weights fingerprint, sha256 of shape + dtype + image bytes)

- the image hash covers the raw pixel bytes and the array's shape and
  dtype, so the same content at two resolutions never collides;
- the weights fingerprint pins entries to one serving model: an engine on
  new weights, or the int8 model of the same weights, has another
  fingerprint, so no entry of the other is ever served.

The store is a bounded LRU (``OrderedDict``: move to the end on a hit,
evict the oldest past capacity) of the features exactly as the engine
fetched them, so a hit returns the same fp32 arrays its miss produced.
Hit, miss, eviction and insert counters flow into the span stream through
``ServeObserver.on_cache`` and into every fleet record. Capacity is
guarded by ``warn_cache_memory`` (``configs/config.py``).
"""

from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def image_key(image) -> str:
    """sha256 of one request image: shape + dtype header, then the raw
    bytes; the reference's key, bitwise."""
    a = np.ascontiguousarray(image)
    h = hashlib.sha256()
    h.update(repr((a.shape, str(a.dtype))).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _tensor_digest(t) -> bytes:
    """sha256 of one tensor: its shape and dtype, then its bytes (bf16 has
    no numpy type, so every tensor hashes through ``.view(torch.uint8)``)."""
    import torch

    t = t.detach().to("cpu").contiguous()
    h = hashlib.sha256(repr((tuple(t.shape), str(t.dtype))).encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy())  # hashed in place
    return h.digest()


def weights_fingerprint(model_or_state) -> str:
    """sha256 over a serving model's ``state_dict`` (or a ``state_dict``):
    each entry's name and the digest of its shape, dtype and bytes, in
    order. Any weight change (a new checkpoint, int8 codes and scales in
    place of bf16 weights) gives a new fingerprint and a cold cache for
    that engine. The entries are hashed on a pool of threads (``hashlib``
    releases the interpreter's lock over large buffers): a ViT-7B serving
    tree is 13.4 GB. The reference hashes flax paths, so the two packages'
    fingerprints differ; each is stable."""
    state = (model_or_state.state_dict()
             if hasattr(model_or_state, "state_dict") else model_or_state)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        digests = list(pool.map(_tensor_digest, state.values()))
    h = hashlib.sha256()
    for name, digest in zip(state, digests):
        h.update(name.encode())
        h.update(digest)
    return h.hexdigest()[:16]


class FeatureCache:
    """Bounded LRU of computed features, keyed content-addressed.

    Values are ``(cls_feature, pooled_patch_feature, n_patches)``, or
    with ``patch_tokens`` as a fourth item when the engine serves
    per-token features (``warn_cache_memory`` then needs the
    ``patch_tokens`` term). ``get`` refreshes recency; ``put`` evicts the
    least recently used entry past ``capacity`` and returns whether it
    evicted (the router forwards that to the observer)."""

    def __init__(self, capacity: int):
        capacity = int(capacity)
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0

    def __len__(self) -> int:
        return len(self._d)

    def key(self, image, fingerprint: str) -> tuple:
        return (str(fingerprint), image_key(image))

    def get(self, key):
        val = self._d.get(key)
        if val is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return val

    def put(self, key, value) -> bool:
        """Insert (or refresh) one entry; True when an LRU eviction made
        room. Stored arrays are frozen (writeable=False) so a caller
        mutating a hit response cannot poison later hits."""
        cls, pooled, n_patches = value[:3]
        cls = np.asarray(cls)
        pooled = np.asarray(pooled)
        cls.flags.writeable = False
        pooled.flags.writeable = False
        stored = (cls, pooled, int(n_patches))
        if len(value) > 3 and value[3] is not None:
            patch = np.asarray(value[3])
            patch.flags.writeable = False
            stored = stored + (patch,)
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = stored
        self.inserts += 1
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1
            return True
        return False

    def clear(self, reset_counters: bool = False) -> None:
        self._d.clear()
        if reset_counters:
            self.hits = self.misses = self.evictions = self.inserts = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "capacity": self.capacity,
            "entries": len(self._d),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "inserts": self.inserts,
            "hit_rate": round(self.hits / total, 4) if total else None,
        }
