"""Step randomness: the packed student pass's drop-path plan."""

from dinov3_tpu_torch.rng.plan import (
    packed_pass_plan,
    plan_layer_slice,
    plan_to_device,
    step_generator,
)

__all__ = ["packed_pass_plan", "plan_layer_slice", "plan_to_device",
           "step_generator"]
