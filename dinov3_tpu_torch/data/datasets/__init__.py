"""Datasets of the host pipelines (PIL is imported here): the image
folder, the synthetic images and ImageNet from a local tree. The
ImageNet-22k, web-shard, tar, ADE20K and caption datasets wait (ROADMAP
M5)."""

from dinov3_tpu_torch.data.datasets.decoders import ImageDataDecoder, TargetDecoder
from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset
from dinov3_tpu_torch.data.datasets.image_folder import ImageFolder
from dinov3_tpu_torch.data.datasets.image_net import ImageNet
from dinov3_tpu_torch.data.datasets.synthetic_images import SyntheticImages

__all__ = ["ExtendedVisionDataset", "ImageDataDecoder", "ImageFolder", "ImageNet",
           "SyntheticImages", "TargetDecoder"]
