"""Host data for the training slice: the synthetic backend, crop-size
lists (``multires``) and the dataset adapter here; the image pipeline
(``data.pipeline``, which imports PIL) is imported only where a real
dataset is chosen."""

from dinov3_tpu_torch.data.adapters import DatasetWithEnumeratedTargets
from dinov3_tpu_torch.data.masking import block_mask, sample_ibot_masks
from dinov3_tpu_torch.data.multires import (
    CombineDataLoader,
    multires_subconfigs,
    split_advance,
)
from dinov3_tpu_torch.data.synthetic import (
    SyntheticDataset,
    batch_spec,
    make_synthetic_batch,
)

__all__ = ["CombineDataLoader", "DatasetWithEnumeratedTargets", "SyntheticDataset",
           "batch_spec", "block_mask", "make_synthetic_batch", "multires_subconfigs",
           "sample_ibot_masks", "split_advance"]
