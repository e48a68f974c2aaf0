"""Feature serving (``dinov3_tpu/serve/``): the packed engine."""

from dinov3_tpu_torch.serve.batcher import (
    ContinuousBatcher,
    PackPlan,
    ServeLayout,
    patch_coords_np,
    patchify,
)
from dinov3_tpu_torch.serve.engine import (
    PackedServeEngine,
    ServeRing,
    build_serve_engine,
    make_serve_step,
    serve_layout_from_cfg,
)
from dinov3_tpu_torch.serve.types import ServeRequest, ServeResponse
from dinov3_tpu_torch.serve.weights import cast_serving_tree, load_serving_model

__all__ = [
    "ContinuousBatcher", "PackPlan", "PackedServeEngine", "ServeLayout",
    "ServeRequest", "ServeResponse", "ServeRing", "build_serve_engine",
    "cast_serving_tree", "load_serving_model", "make_serve_step",
    "patch_coords_np", "patchify", "serve_layout_from_cfg",
]
