"""Run telemetry: the ``--benchmark`` step timer (the rest of
``dinov3_tpu/telemetry`` waits, ROADMAP M11)."""

from dinov3_tpu_torch.telemetry.spans import StepTimer

__all__ = ["StepTimer"]
