"""Precision policy, initializers and device resolution.

Counterpart of ``dinov3_tpu/ops/common.py``: parameters live in
``param_dtype`` (fp32 masters), matmuls and activations run in
``compute_dtype`` (bf16), norm and softmax statistics accumulate in fp32
(always: the config's ``reduce_dtype`` is fp32 in every recipe).
"""

from __future__ import annotations

import dataclasses

import torch

DTYPE_MAP = {
    "fp32": torch.float32, "float32": torch.float32, "f32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp16": torch.float16, "float16": torch.float16,
    "fp64": torch.float64, "float64": torch.float64,
}


def canonical_dtype(name):
    """A dtype name ("bf16", "fp32", ...) -> torch dtype; dtypes and None
    pass through."""
    if name is None or not isinstance(name, str):
        return name
    try:
        return DTYPE_MAP[name.lower()]
    except KeyError as e:
        raise ValueError(f"unknown dtype name {name!r}") from e


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed precision policy (the ``compute_precision`` config block)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @classmethod
    def from_cfg(cls, precision_cfg) -> "Policy":
        return cls(
            param_dtype=canonical_dtype(precision_cfg.get("param_dtype", "fp32")),
            compute_dtype=canonical_dtype(
                precision_cfg.get("compute_dtype", "bf16")),
        )


def trunc_normal_init(tensor: torch.Tensor, generator: torch.Generator,
                      stddev: float = 0.02) -> torch.Tensor:
    """DINOv3 init: normal with std ``stddev`` truncated at +-1 in
    unscaled units (the JAX ``trunc_normal_init``'s bounds)."""
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(tensor, std=stddev, a=-1.0, b=1.0,
                                           generator=generator)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
          dtype: torch.dtype) -> torch.Tensor:
    """``x @ weight.T + bias`` with input, weight and bias cast to the
    compute dtype; the bias is added after the product, as the JAX Dense
    layers do, not fused into it."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    return y if bias is None else y + bias.to(dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x * rsqrt(sum(x^2) + eps^2)``: eps inside the rsqrt, so value and
    gradient stay finite at x == 0 (``x / (||x|| + eps)`` has a 0/0
    gradient there)."""
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps * eps)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` without a card
    raises (pass ``device="cpu"`` for the plain versions of the kernels).

    On CUDA it also sets fp32 matmuls and cuDNN convolutions to full fp32
    (``allow_tf32 = False`` for both), so an fp32 model computes in fp32
    as the reference does; TF32 keeps about three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain versions of the kernels")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected cuda or cpu")
    return dev


# ---------------------------------------------------------------------
# the legacy ``student.fp8_enabled`` hook (``dinov3_tpu/ops/common.py
# fp8_dot_general``): current per-tensor scaling of both operands into
# float8_e4m3, an fp8 product with fp32 accumulation, the product of the
# scales applied to the output. Its backward is what JAX's autodiff makes
# of that forward: the cotangent, times both scales, multiplied with the
# other operand's codes in fp32, cast to float8_e4m3 (unscaled, so small
# gradients flush to zero), divided by the operand's own scale.
# ---------------------------------------------------------------------

_F8_MAX = 448.0  # float8_e4m3 finite max


def _fp8_quantize(t: torch.Tensor):
    tf = t.float()
    scale = tf.abs().amax().clamp_min(1e-12) / _F8_MAX
    return (tf / scale).to(torch.float8_e4m3fn), scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        from dinov3_tpu_torch.ops.lowp import codes_matmul, dequantize

        ql, sl = _fp8_quantize(x.detach())
        qr, sr = _fp8_quantize(w.detach())
        acc = codes_matmul(ql.reshape(-1, x.shape[-1]), qr, "fp8")
        ctx.save_for_backward(ql, sl, qr, sr)
        ctx.dtypes = (x.dtype, w.dtype)
        return dequantize(acc, sl * sr, x.dtype).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        ql, sl, qr, sr = ctx.saved_tensors
        gs = g.float() * (sl * sr)
        f8 = torch.float8_e4m3fn
        dx = (gs @ qr.float()).to(f8).float() / sl
        dw = (gs.reshape(-1, gs.shape[-1]).t() @ ql.reshape(-1, ql.shape[-1]).float())
        dw = dw.to(f8).float() / sr
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1])


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` through the fp8 hook: x [..., K], w [N, K] (Linear
    layout), output in x's dtype."""
    return _Fp8Matmul.apply(x, w)
