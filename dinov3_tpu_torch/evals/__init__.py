"""Frozen-feature evaluation (``dinov3_tpu/evals``): feature extraction,
weighted k-NN, the linear probe and its lr sweep, the harness a training
run calls, and the standalone ``python -m dinov3_tpu_torch.evals``."""

from dinov3_tpu_torch.evals.features import (
    extract_features,
    extract_features_serve,
    make_feature_fn,
)
from dinov3_tpu_torch.evals.harness import do_eval
from dinov3_tpu_torch.evals.knn import knn_classify, knn_eval, knn_eval_multi
from dinov3_tpu_torch.evals.linear import (
    DEFAULT_PROBE_LRS,
    DEFAULT_PROBE_WDS,
    linear_probe_eval,
    linear_probe_sweep,
)

__all__ = [
    "DEFAULT_PROBE_LRS", "DEFAULT_PROBE_WDS", "do_eval", "extract_features",
    "extract_features_serve", "knn_classify", "knn_eval", "knn_eval_multi",
    "linear_probe_eval", "linear_probe_sweep", "make_feature_fn",
]
