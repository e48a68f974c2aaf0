"""Host data for the training slice: the synthetic backend here; the
image-folder pipeline (``data.pipeline``, which imports PIL) is imported
only where ``data.backend=folder`` is chosen."""

from dinov3_tpu_torch.data.masking import block_mask, sample_ibot_masks
from dinov3_tpu_torch.data.synthetic import (
    SyntheticDataset,
    batch_spec,
    make_synthetic_batch,
)

__all__ = ["SyntheticDataset", "batch_spec", "block_mask",
           "make_synthetic_batch", "sample_ibot_masks"]
