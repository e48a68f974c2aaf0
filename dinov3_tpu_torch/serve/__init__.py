"""Feature serving (``dinov3_tpu/serve/``).

A continuous batcher packs variable-resolution images into fixed
token-budget rows (``batcher.py``); one segment-masked forward serves every
pack (``engine.py PackedServeEngine``); the naive per-shape oracle engines
stay behind ``serve.continuous_packing=false`` (``OracleServeEngine``).
Weights come from a ``state_dict``, a training checkpoint or a seed
(``weights.py``). On top: int8 per-channel weights dequantized per layer
at use (``quant.py``), an SLO- and shape-routed pool of engines behind
one admission layer (``fleet.py``), and a content-addressed LRU feature
cache in front of the batchers (``cache.py``). The replay harness that
drives them all is ``python -m dinov3_tpu_torch.serve.bench``.
"""

from dinov3_tpu_torch.serve.batcher import (
    ContinuousBatcher,
    PackPlan,
    ServeLayout,
    patch_coords_np,
    patchify,
)
from dinov3_tpu_torch.serve.cache import (
    FeatureCache,
    image_key,
    weights_fingerprint,
)
from dinov3_tpu_torch.serve.engine import (
    OracleServeEngine,
    PackedServeEngine,
    ServeRing,
    build_serve_engine,
    make_serve_step,
    serve_layout_from_cfg,
)
from dinov3_tpu_torch.serve.fleet import (
    EngineSpec,
    FleetRouter,
    build_serve_fleet,
    layout_from_envelope,
)
from dinov3_tpu_torch.serve.quant import (
    QuantLinear,
    dequantize_state_dict,
    is_quantized,
    quant_feature_drift,
    quant_summary,
    quantizable_path,
    quantize_serving_model,
    quantize_state_dict,
)
from dinov3_tpu_torch.serve.types import ServeRequest, ServeResponse
from dinov3_tpu_torch.serve.weights import cast_serving_tree, load_serving_model

__all__ = [
    "ContinuousBatcher", "EngineSpec", "FeatureCache", "FleetRouter",
    "OracleServeEngine", "PackPlan", "PackedServeEngine", "QuantLinear",
    "ServeLayout", "ServeRequest", "ServeResponse", "ServeRing",
    "build_serve_engine", "build_serve_fleet", "cast_serving_tree",
    "dequantize_state_dict", "image_key", "is_quantized", "layout_from_envelope",
    "load_serving_model", "make_serve_step", "patch_coords_np", "patchify",
    "quant_feature_drift", "quant_summary", "quantizable_path",
    "quantize_serving_model",
    "quantize_state_dict", "serve_layout_from_cfg", "weights_fingerprint",
]
