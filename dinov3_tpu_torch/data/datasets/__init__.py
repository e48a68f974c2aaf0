"""Datasets of the image-folder pipeline (PIL is imported here). The
ImageNet, ImageNet-22k, web-shard and tar datasets wait (ROADMAP M5)."""

from dinov3_tpu_torch.data.datasets.decoders import ImageDataDecoder, TargetDecoder
from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset
from dinov3_tpu_torch.data.datasets.image_folder import ImageFolder

__all__ = ["ExtendedVisionDataset", "ImageDataDecoder", "ImageFolder",
           "TargetDecoder"]
