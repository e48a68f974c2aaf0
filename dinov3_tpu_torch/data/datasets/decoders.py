"""Sample decoding (``dinov3_tpu/data/datasets/decoders.py``): stored bytes
-> RGB PIL image; targets are stored decoded."""

from __future__ import annotations

import io
from typing import Any

from PIL import Image


def decode_rgb_image(data: bytes) -> Image.Image:
    """JPEG/PNG/... bytes -> RGB PIL image."""
    return Image.open(io.BytesIO(data)).convert("RGB")


def decode_target(value: Any) -> Any:
    """Targets are stored decoded (int class index, caption str, ...)."""
    return value


class ImageDataDecoder:
    """``ImageDataDecoder(data).decode()``, as ``ExtendedVisionDataset``
    calls it."""

    __slots__ = ("_data",)

    def __init__(self, image_data: bytes) -> None:
        self._data = image_data

    def decode(self) -> Image.Image:
        return decode_rgb_image(self._data)


class TargetDecoder:
    __slots__ = ("_value",)

    def __init__(self, target: Any) -> None:
        self._value = target

    def decode(self) -> Any:
        return decode_target(self._value)
