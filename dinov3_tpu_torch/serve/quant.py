"""int8 serving weights (``dinov3_tpu/serve/quant.py``).

Per-output-channel symmetric int8 over the attention and MLP matmul
weights (``ops/lowp.py lowp_kernel_path``); biases, norms, LayerScale,
the patch embedding and the tokens stay bf16. Quantization happens once,
at engine build, on the host, in fp32 numpy from the bf16 serving
weights: ``scale = amax(|W|) / 127`` per output channel (1.0 for a zero
channel), codes ``rint(W / scale)`` (half to even) clipped to ±127. An
``nn.Linear`` weight is [out, in], so the scale reduces dim -1 and has
shape [out, 1]; the reference's kernels are [in, out] with scales over
axis -2, so the port's codes are the reference's transposed, bitwise.

``QuantLinear`` keeps the codes (int8) and scales (fp32) as buffers on
the model's device and the bias in bf16. Its ``weight`` dequantizes at
each use, ``(q.float() * scale).to(bfloat16)``, the reference's
expression, so a quantized layer's dense bf16 weight lives only while
its product runs: the card holds the int8 codes, not a bf16 copy. The
attention and MLP modules read ``.weight`` as they do from an
``nn.Linear``, so the same forward code serves both models; the product
is the plain bf16 matmul (a fused dequantize-GEMM is a speed-up for a
later change).
"""

from __future__ import annotations

import copy
import itertools

import numpy as np
import torch
from torch import nn

from dinov3_tpu_torch.ops.lowp import (
    lowp_kernel_path,
    symmetric_quantize,
    symmetric_scale,
)

QMAX = 127


class QuantLinear(nn.Module):
    """A frozen Linear layer held as int8 codes [out, in], fp32 scales
    [out, 1] and a bf16 bias (or none)."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bias = (None if bias is None
                     else nn.Parameter(bias, requires_grad=False))

    @property
    def weight(self) -> torch.Tensor:
        return (self.q.float() * self.scale).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x.to(self.dtype), self.weight,
                                    None if self.bias is None
                                    else self.bias.to(self.dtype))


def quantize_weight(w: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """One [out, in] weight -> (int8 codes [out, in], fp32 scales
    [out, 1]), in fp32 numpy on the host (bf16 widens to fp32 exactly)."""
    w32 = w.detach().to("cpu", torch.float32).numpy()
    scale = symmetric_scale(np.max(np.abs(w32), axis=-1, keepdims=True), QMAX)
    return symmetric_quantize(w32, scale, QMAX, np.int8), scale


def quantize_state_dict(state_dict: dict) -> dict:
    """A bf16 serving ``state_dict`` -> the int8 one: each
    ``lowp_kernel_path`` weight ``<m>.weight`` becomes ``<m>.q`` (int8)
    and ``<m>.scale`` (fp32), on the host; every other entry is kept as
    it is. The input is left alone."""
    out = {}
    for name, t in state_dict.items():
        if quantizable_path(name):
            q, scale = quantize_weight(t)
            base = name[: -len(".weight")]
            out[f"{base}.q"] = torch.from_numpy(q)
            out[f"{base}.scale"] = torch.from_numpy(scale)
        else:
            out[name] = t
    return out


def _skeleton(model: nn.Module) -> nn.Module:
    """A copy of ``model``'s modules whose tensors are empty ``meta``
    placeholders: nothing is copied on the model's device."""
    memo = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (nn.Parameter(meta, requires_grad=False)
                       if isinstance(t, nn.Parameter) else meta)
    return copy.deepcopy(model, memo)


def quantize_serving_model(model: nn.Module, qstate: dict | None = None) -> nn.Module:
    """The int8 twin of a bf16 serving model (``quantize_serving_tree``):
    a new model, on the same device, whose attention and MLP Linear
    layers are ``QuantLinear``s; the bf16 model is left alone. The codes
    are computed on the host from the model's weights, or taken from
    ``qstate`` (an int8 ``state_dict`` as ``quantize_state_dict`` or
    ``interop.quant_state_from_jax`` give). A quantized model is returned
    as it is."""
    if is_quantized(model):
        return model
    device = next(model.parameters()).device
    if qstate is None:
        qstate = quantize_state_dict(
            {k: v.detach().cpu() for k, v in model.state_dict().items()})
    new = _skeleton(model)
    for name, mod in list(new.named_modules()):
        if isinstance(mod, nn.Linear) and quantizable_path(f"{name}.weight"):
            parent_name, _, attr = name.rpartition(".")
            parent = new.get_submodule(parent_name) if parent_name else new
            q = qstate[f"{name}.q"]
            bias = None if mod.bias is None else qstate[f"{name}.bias"]
            setattr(parent, attr, QuantLinear(
                q.to(device), qstate[f"{name}.scale"].to(device),
                None if bias is None else bias.to(device)))
    rest = {k: v for k, v in qstate.items() if not _in_quant_linear(new, k)}
    new.load_state_dict({k: v.to(device) for k, v in rest.items()},
                        strict=False, assign=True)
    missing = [k for k, v in itertools.chain(new.named_parameters(), new.named_buffers())
               if v.device.type == "meta"]
    if missing:
        raise KeyError(f"int8 state lacks {missing[:5]}")
    return new.requires_grad_(False).eval()


def _in_quant_linear(model: nn.Module, key: str) -> bool:
    mod_name = key.rpartition(".")[0]
    try:
        return isinstance(model.get_submodule(mod_name), QuantLinear)
    except AttributeError:
        return False


def quantizable_path(name: str) -> bool:
    """Whether the ``state_dict`` entry ``name`` is int8-quantized: the
    ``ops/lowp.py lowp_kernel_path`` rule, which owns it."""
    return lowp_kernel_path(name)


def dequantize_state_dict(state: dict, dtype=torch.bfloat16) -> dict:
    """An int8 ``state_dict`` -> the dense one (``dequantize_tree``):
    each ``<m>.q`` / ``<m>.scale`` pair becomes ``<m>.weight`` =
    ``(q.float() * scale).to(dtype)``, the expression ``QuantLinear``
    runs at each use; other entries pass."""
    out = {}
    for name, t in state.items():
        if name.endswith(".q"):
            base = name[:-2]
            out[f"{base}.weight"] = (t.float() * state[f"{base}.scale"]).to(dtype)
        elif not (name.endswith(".scale") and f"{name[:-6]}.q" in state):
            out[name] = t
    return out


def is_quantized(model: nn.Module) -> bool:
    return any(isinstance(m, QuantLinear) for m in model.modules())


def quant_summary(model: nn.Module) -> dict:
    """Byte accounting of a (possibly) int8 model, the reference's keys:
    resident weight bytes against the dense-bf16 equivalent, and how many
    weights are int8. A ``QuantLinear``'s codes and scales count as one
    weight, as a ``QuantLeaf`` is one leaf."""
    n_quant = n_leaves = 0
    bytes_resident = bytes_bf16 = 0
    for name, t in model.state_dict().items():
        if name.endswith(".scale") and _in_quant_linear(model, name):
            continue
        n_leaves += 1
        if name.endswith(".q") and _in_quant_linear(model, name):
            n_quant += 1
            bytes_resident += t.numel() + t.shape[0] * 4
            bytes_bf16 += t.numel() * 2
        else:
            b = t.numel() * t.element_size()
            bytes_resident += b
            bytes_bf16 += b
    return {
        "quantized_kernels": n_quant,
        "n_leaves": n_leaves,
        "weight_bytes": int(bytes_resident),
        "bf16_weight_bytes": int(bytes_bf16),
        "bytes_ratio": (round(bytes_resident / bytes_bf16, 4)
                        if bytes_bf16 else 1.0),
    }


def quant_feature_drift(bf16_model: nn.Module, int8_model: nn.Module, px: int,
                        seed: int = 0) -> dict:
    """Measured int8-vs-bf16 feature drift: one plain forward of each
    model (CLS and mean-pooled patch features, the oracle's extraction)
    on one seeded [1, px, px, 3] normal image; max |diff| per view."""
    x = np.random.default_rng(seed).standard_normal(
        (1, int(px), int(px), 3)).astype(np.float32)
    views = []
    for model in (bf16_model, int8_model):
        dev = next(model.parameters()).device
        with torch.inference_mode():
            out = model(torch.from_numpy(x).to(dev))
            views.append((out["x_norm_clstoken"].float(),
                          out["x_norm_patchtokens"].float().mean(1)))
    (cls_a, pooled_a), (cls_b, pooled_b) = views
    return {
        "probe_px": int(px),
        "cls_max_abs_diff": float((cls_a - cls_b).abs().max()),
        "pooled_max_abs_diff": float((pooled_a - pooled_b).abs().max()),
    }
