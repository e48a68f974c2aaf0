from dinov3_tpu_torch.interop.from_jax import (
    convnext_state_dict_from_jax,
    head_state_dict_from_jax,
    meta_state_dicts_from_jax,
    params_state_dicts_from_jax,
    quant_state_from_jax,
    state_dict_from_jax,
    train_state_from_jax,
)
from dinov3_tpu_torch.interop.torch_convert import (
    convert_meta_state_dict,
    load_backbone_from_meta,
    read_meta_weights,
)

__all__ = ["convert_meta_state_dict", "convnext_state_dict_from_jax", "head_state_dict_from_jax", "load_backbone_from_meta",
           "meta_state_dicts_from_jax", "params_state_dicts_from_jax", "quant_state_from_jax",
           "read_meta_weights", "state_dict_from_jax", "train_state_from_jax"]
