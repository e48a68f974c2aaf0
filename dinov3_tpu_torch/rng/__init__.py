"""Step randomness: the student passes' plans (drop path, RoPE factors)."""

from dinov3_tpu_torch.rng.plan import (
    fold_in_plan,
    packed_pass_plan,
    plan_layer_slice,
    plan_to_device,
    step_generator,
    step_plan,
)

__all__ = ["fold_in_plan", "packed_pass_plan", "plan_layer_slice", "plan_to_device",
           "step_generator", "step_plan"]
