"""Datasets of the host pipelines (PIL is imported here): the image
folder, the synthetic images, ImageNet from a local tree, ImageNet-22k
from per-class tarballs and webdataset-style shards. The ADE20K and
caption datasets wait (ROADMAP M12)."""

from dinov3_tpu_torch.data.datasets.decoders import ImageDataDecoder, TargetDecoder
from dinov3_tpu_torch.data.datasets.extended import ExtendedVisionDataset
from dinov3_tpu_torch.data.datasets.image_folder import ImageFolder
from dinov3_tpu_torch.data.datasets.image_net import ImageNet
from dinov3_tpu_torch.data.datasets.image_net_22k import ImageNet22k
from dinov3_tpu_torch.data.datasets.synthetic_images import SyntheticImages
from dinov3_tpu_torch.data.datasets.tar_backed import TarMmapCache
from dinov3_tpu_torch.data.datasets.web_shards import WebShards

__all__ = ["ExtendedVisionDataset", "ImageDataDecoder", "ImageFolder", "ImageNet",
           "ImageNet22k", "SyntheticImages", "TarMmapCache", "TargetDecoder",
           "WebShards"]
