from dinov3_tpu_torch.interop.from_jax import state_dict_from_jax

__all__ = ["state_dict_from_jax"]
