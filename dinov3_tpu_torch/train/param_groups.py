"""Per-parameter lr/wd multipliers by parameter name
(``dinov3_tpu/train/param_groups.py``, read on the port's Meta-style names).

- layerwise lr decay: ``decay ** (L + 1 - layer)``, layer 0 for the patch
  embed and the tokens, i + 1 for block i, L + 1 for the rest (norms,
  heads);
- the patch embed's lr times ``patch_embed_lr_mult``;
- weight decay 0 for biases, norms and LayerScale gammas, and
  ``dino_head_wd_multiplier`` for the DINO head;
- the prototype layer (``last_layer``) is the "last layer" whose lr is
  frozen for the first epochs.
"""

from __future__ import annotations

import dataclasses
import re

_EMBED_TOKENS = ("pos_embed", "patch_embed", "mask_token", "cls_token",
                 "storage_tokens")
_BLOCK = re.compile(r"(?:^|\.)blocks\.(\d+)\.")


@dataclasses.dataclass(frozen=True)
class Multipliers:
    lr: float
    wd: float
    is_last_layer: bool


def _layer_id(name: str, num_layers: int) -> int:
    if any(tok in name for tok in _EMBED_TOKENS):
        return 0
    m = _BLOCK.search(name)
    return int(m.group(1)) + 1 if m else num_layers + 1


def infer_num_layers(names) -> int:
    ids = [int(m.group(1)) for n in names if (m := _BLOCK.search(n))]
    return max(ids) + 1 if ids else 0


def build_multipliers(names, layerwise_decay: float = 1.0,
                      patch_embed_lr_mult: float = 1.0,
                      dino_head_wd_multiplier: float = 1.0,
                      num_layers: int | None = None) -> dict[str, Multipliers]:
    """{parameter name: Multipliers} for the student's parameter names
    (``backbone.blocks.3.attn.qkv.weight``, ``dino_head.last_layer.weight``)."""
    names = list(names)
    if num_layers is None:
        num_layers = infer_num_layers(names)
    out = {}
    for name in names:
        lr = layerwise_decay ** (num_layers + 1 - _layer_id(name, num_layers))
        if "patch_embed" in name:
            lr *= patch_embed_lr_mult
        wd = dino_head_wd_multiplier if "dino_head" in name else 1.0
        if name.endswith("bias") or "norm" in name \
                or name.rsplit(".", 1)[-1] == "gamma":
            wd = 0.0
        out[name] = Multipliers(lr, wd, "last_layer" in name)
    return out
