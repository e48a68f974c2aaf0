"""Batched backbone feature extraction for the evals
(``dinov3_tpu/evals/features.py``).

``extract_features`` runs same-shape batches through the backbone's
forward on the model's device: each host batch goes to the card from
pinned memory without blocking, and a batch's features are read back
once, after the next batch has been queued, so the host's work on the
next batch overlaps the card's on this one. A ragged final batch runs at
its own size, unpadded: the JAX package pads it to the first batch's
rows only to reuse its one compiled program, and the port compiles
nothing. Variable-resolution traffic is the serve engine's job:
``extract_features_serve`` rides ``serve.PackedServeEngine``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator

import numpy as np
import torch


def make_feature_fn(model) -> Callable:
    """[B, H, W, 3] images on the model's device -> [B, D] fp32 CLS
    features (the final CLS norm), under ``torch.inference_mode``."""

    def feat(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)["x_norm_clstoken"].float()

    return feat


def _to_device(image, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(image))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def extract_features(model, batches: Iterator[dict],
                     max_batches: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """batches: dicts with "image" [B, H, W, 3] and "label" [B] (numpy),
    at most ``max_batches`` of them taken. Returns (features [N, D] fp32,
    labels [N] int64) on the host."""
    device = next(model.parameters()).device
    feat = make_feature_fn(model)
    feats, labels = [], []
    queued = None
    for batch in itertools.islice(batches, max_batches):
        out = feat(_to_device(batch["image"], device))
        if queued is not None:
            feats.append(queued.cpu().numpy())
        queued = out
        labels.append(np.asarray(batch["label"], np.int64))
    if queued is None:
        raise ValueError("no batches to extract features from")
    feats.append(queued.cpu().numpy())
    return np.concatenate(feats), np.concatenate(labels)


def extract_features_serve(engine, images: Iterator[np.ndarray],
                           labels: Iterator[int] | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Variable-resolution extraction through a serve engine: ``images``
    yields [H, W, 3] float arrays of any admissible resolution; the CLS
    features come back in submission order. Returns (features [N, D]
    fp32, labels [N] int64, zeros when ``labels`` is None)."""
    n = 0
    for i, image in enumerate(images):
        engine.submit(np.asarray(image), request_id=i)
        n += 1
    if n == 0:
        raise ValueError("no images to extract features from")
    responses = []
    while engine.queue_len:
        responses.extend(engine.flush())
    responses.sort(key=lambda r: r.request_id)
    feats = np.stack([r.cls_feature for r in responses])
    lab = (np.asarray(list(labels), np.int64) if labels is not None
           else np.zeros((n,), np.int64))
    return feats, lab
