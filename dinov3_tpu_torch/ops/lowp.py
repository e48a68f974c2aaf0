"""Low-precision numerics (``dinov3_tpu/ops/lowp.py``), the part serving
needs: the symmetric scale and quantizer in numpy form, and the rule that
picks the quantized weights. The fp8/int8 training arms wait (ROADMAP M9).
"""

from __future__ import annotations

import numpy as np


def symmetric_scale(amax, qmax):
    """``amax / qmax`` in fp32, zero-amax channels at scale 1.0 (the
    divide stays exact and dequantization gives exact zeros)."""
    amax = np.asarray(amax, np.float32)
    return np.where(amax > 0, amax / np.float32(qmax),
                    np.float32(1.0)).astype(np.float32)


def symmetric_quantize(w, scale, qmax, qdtype):
    """Symmetric quantization of ``w`` by ``scale`` in fp32: integer
    types round half to even (``np.rint``) and clip to [-qmax, qmax];
    float types clip and let the cast round."""
    w32 = np.asarray(w, np.float32) / scale
    if np.issubdtype(np.dtype(qdtype), np.integer):
        w32 = np.rint(w32)
    return np.clip(w32, -qmax, qmax).astype(qdtype)


def lowp_kernel_path(name: str) -> bool:
    """Whether the ``state_dict`` entry ``name`` is a low-precision matmul
    weight: the ``weight`` of a Linear layer under ``.attn.`` or ``.mlp.``
    and not of a router. The reference's rule (``stream_castable_path``
    narrowed to kernels) in the port's names: ``blocks.N.attn.qkv.weight``,
    ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``; biases, norms, LayerScale and
    the patch embedding stay out."""
    parts = name.split(".")
    return (parts[-1] == "weight" and bool({"attn", "mlp"} & set(parts[:-1]))
            and not any("router" in p for p in parts))
