"""SSL losses (``dinov3_tpu/losses``): Sinkhorn-Knopp and softmax
centering, the DINO crop-pair and iBOT masked-token cross-entropies over
materialized targets or streamed K-tile by K-tile
(``losses/streaming.py``), the KoLeo regularizer and the Gram anchoring
loss. Statistics and reductions accumulate in fp32."""

from dinov3_tpu_torch.losses.dino_loss import (
    dino_pair_ce,
    pair_ce_to_loss,
    softmax_center_teacher,
    update_center,
)
from dinov3_tpu_torch.losses.gram_loss import gram_loss
from dinov3_tpu_torch.losses.ibot_loss import (
    ibot_patch_loss_from_parts,
    ibot_patch_loss_masked,
)
from dinov3_tpu_torch.losses.koleo_loss import koleo_loss
from dinov3_tpu_torch.losses.sinkhorn import SinkhornFactors, sinkhorn_knopp
from dinov3_tpu_torch.losses.streaming import (
    choose_k_tile,
    ibot_loss_from_spec,
    pair_ce_from_spec,
)

__all__ = ["SinkhornFactors", "choose_k_tile", "dino_pair_ce",
           "gram_loss", "ibot_loss_from_spec", "ibot_patch_loss_from_parts",
           "ibot_patch_loss_masked", "koleo_loss", "pair_ce_from_spec",
           "pair_ce_to_loss", "sinkhorn_knopp", "softmax_center_teacher",
           "update_center"]
