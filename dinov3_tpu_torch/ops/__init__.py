"""Layers and kernels of the port (``dinov3_tpu/ops/``)."""
