from dinov3_tpu_torch.interop.from_jax import (
    head_state_dict_from_jax,
    meta_state_dicts_from_jax,
    state_dict_from_jax,
    teacher_backbone_from_jax,
    train_state_from_jax,
)

__all__ = ["head_state_dict_from_jax", "meta_state_dicts_from_jax",
           "state_dict_from_jax", "teacher_backbone_from_jax",
           "train_state_from_jax"]
