"""Host data for the training slice: the synthetic backend only."""

from dinov3_tpu_torch.data.masking import block_mask, sample_ibot_masks
from dinov3_tpu_torch.data.synthetic import batch_spec, make_synthetic_batch

__all__ = ["batch_spec", "block_mask", "make_synthetic_batch",
           "sample_ibot_masks"]
