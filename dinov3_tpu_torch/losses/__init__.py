"""SSL losses with materialized teacher targets (``dinov3_tpu/losses``):
Sinkhorn-Knopp centering, the DINO crop-pair cross-entropy, the iBOT
masked-token cross-entropy and the KoLeo regularizer. Statistics and
reductions accumulate in fp32."""

from dinov3_tpu_torch.losses.dino_loss import dino_pair_ce, pair_ce_to_loss
from dinov3_tpu_torch.losses.ibot_loss import ibot_patch_loss_masked
from dinov3_tpu_torch.losses.koleo_loss import koleo_loss
from dinov3_tpu_torch.losses.sinkhorn import sinkhorn_knopp

__all__ = ["dino_pair_ce", "ibot_patch_loss_masked", "koleo_loss",
           "pair_ce_to_loss", "sinkhorn_knopp"]
