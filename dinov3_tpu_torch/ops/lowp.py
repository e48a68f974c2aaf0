"""Low-precision numerics (``dinov3_tpu/ops/lowp.py``): the serving
quantizer in numpy form, and the fp8 / int8 training arms.

``train.low_precision.arm`` (bf16 | fp8 | int8; bf16, the default, is the
unchanged path) quantizes exactly the block matmul weights that
``lowp_kernel_path`` picks (attention ``qkv`` and ``proj``, MLP ``fc1`` and
``fc2``, SwiGLU ``w12`` and ``w3``); biases, norms, LayerScale, the patch
embedding and the heads stay bf16 / fp32.

- **Per-tensor delayed scaling.** Each such weight has an amax history
  ring in ``TrainState.lowp`` (fp32 [H], keyed by its ``state_dict``
  name within the backbone); the step's weight scale is
  ``scale_margin * max(history) / qmax``, one step behind the masters.
  The rings advance after AdamW and the EMA from the updated masters,
  under ``record_function("lowp_amax")``. Activations take current
  per-tensor scaling (one amax a tensor, no gradient).
- **Student and teacher.** The EMA teacher's forward runs the same
  quantized products with its own rings; its fp32 masters never see a
  quantizer.
- **The products.** ``lowp_matmul`` quantizes the bf16 view of the
  weight and the activation, multiplies the codes with the arm's
  accumulator (int32 for int8, fp32 for fp8) and dequantizes by
  ``s_x * s_w`` under ``record_function("lowp_dequant")``. The reference
  computes these as XLA dots outside any Pallas kernel; on the card the
  port calls the library's low-precision GEMMs, ``torch._int_mm`` and
  ``torch._scaled_mm`` (``use_fast_accum=False``), padding a shape that
  breaks their alignment rules, never falling back. On the CPU it runs
  the plain version: int8 sums the code products exactly in float64
  (fp32 is not exact once 127^2 * K passes 2^24), so the card's int32
  result equals it bit for bit; fp8 dequantizes the codes to fp32 and
  multiplies.
- **The backward** is the reference's straight-through one: dx = g @ ŵ
  from the dequantized weight codes, dw = x̂ᵀ g from the saved activation
  codes, no gradient to the scales; only codes and scales are saved,
  never the wide activation.

``_gather_codes`` is the reference's ZeRO-3 stream of the 1-byte codes;
at world size 1 it is the identity (the sharded arms wait, ROADMAP M7).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

LOWP_ARMS = ("bf16", "fp8", "int8")


class QSpec(NamedTuple):
    """One quantized arm: code dtype, symmetric max code, accumulator."""

    qdtype: torch.dtype
    qmax: float
    acc_dtype: torch.dtype


_QSPECS = {
    # float8_e4m3 finite max 448; fp8 products accumulate in fp32
    "fp8": QSpec(torch.float8_e4m3fn, 448.0, torch.float32),
    # symmetric int8 in [-127, 127]; int8 products accumulate in int32
    "int8": QSpec(torch.int8, 127.0, torch.int32),
}


def qspec(arm: str) -> QSpec:
    if arm not in _QSPECS:
        raise ValueError(f"unknown low-precision arm {arm!r}; expected one of {LOWP_ARMS}")
    return _QSPECS[arm]


# ---------------------------------------------------------------------
# serving's numpy quantizer
# ---------------------------------------------------------------------

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


# ---------------------------------------------------------------------
# the training quantizer (torch)
# ---------------------------------------------------------------------

def quantize(w: torch.Tensor, scale: torch.Tensor, spec: QSpec) -> torch.Tensor:
    """``symmetric_quantize`` on tensors: ``w / scale`` in fp32, int8
    rounded half to even (``torch.round``, as ``rint``), clipped to
    [-qmax, qmax] before the cast (the cast to float8_e4m3fn does not
    saturate). The division reads ``w`` in its own dtype and writes fp32
    in one pass (a 1-element ``scale`` promotes the quotient to fp32)."""
    w32 = torch.div(w, scale.reshape(1).float())
    if not spec.qdtype.is_floating_point:
        w32.round_()
    return w32.clamp_(-spec.qmax, spec.qmax).to(spec.qdtype)


def dequantize(t: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``(t.float() * scale).to(dtype)`` in one pass over ``t`` (codes or
    an int32 / fp32 product): the product in fp32, rounded once to
    ``dtype``. fp8 codes widen to bf16 first, exactly (torch does not
    promote float8 types)."""
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.to(torch.bfloat16)
    return torch.mul(t, scale.reshape(1).float(), out=torch.empty(t.shape, dtype=dtype,
                                                                    device=t.device))


def scale_from_history(hist: torch.Tensor, qmax: float, margin: float) -> torch.Tensor:
    """Delayed-scaling weight scale from amax history rings (last axis):
    ``margin * max(history) / qmax``; an all-zero history scales by 1."""
    amax = hist.float().amax(dim=-1) * margin
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def current_scale(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """Current per-tensor activation scale, no gradient: ``max(amax,
    1e-12) / qmax`` (a zero tensor quantizes to zeros, finite scale). The
    amax is exact in ``x``'s own dtype: one ``aminmax`` read of ``x``."""
    with torch.profiler.record_function("lowp_amax"):
        lo, hi = torch.aminmax(x.detach())
        return torch.maximum(-lo, hi).float().clamp_min(1e-12) / qmax


# ---------------------------------------------------------------------
# which weights, and where their scales live
# ---------------------------------------------------------------------

def lowp_kernel_path(name: str) -> bool:
    """Whether the ``state_dict`` entry ``name`` is a low-precision matmul
    weight: the ``weight`` of a Linear layer under ``.attn.`` or ``.mlp.``
    and not of a router. The reference's rule (``stream_castable_path``
    narrowed to kernels) in the port's names: ``blocks.N.attn.qkv.weight``,
    ``attn.proj``, ``mlp.fc1``, ``mlp.fc2``, ``mlp.w12``, ``mlp.w3``; biases,
    norms, LayerScale and the patch embedding stay out."""
    parts = name.split(".")
    return (parts[-1] == "weight" and bool({"attn", "mlp"} & set(parts[:-1]))
            and not any("router" in p for p in parts))


def lowp_scale_site(name: str) -> tuple[str, str]:
    """Where a weight's scale is read: (the module that owns the Linear,
    the Linear's attribute name), e.g. ``blocks.3.mlp.fc1.weight`` ->
    (``blocks.3.mlp``, ``fc1``) — the reference's ``fc1_kernel`` site."""
    parts = name.split(".")
    return ".".join(parts[:-2]), parts[-2]


def _lowp_weights(backbone: torch.nn.Module) -> dict:
    return {n: p for n, p in backbone.named_parameters() if lowp_kernel_path(n)}


def lowp_amax_tree(backbone: torch.nn.Module) -> dict:
    """{weight name: amax of its fp32 master (0-d fp32)}, over the
    castable weights, by one fused max-norm over all of them."""
    weights = _lowp_weights(backbone)
    with torch.no_grad():
        amax = torch._foreach_norm([p.detach() for p in weights.values()], float("inf"))
    return {n: a.float() for n, a in zip(weights, amax)}


def lowp_history_init(backbone: torch.nn.Module, history_len: int) -> dict:
    """Fresh amax rings, every slot the current masters' amax (a zero
    history would scale the first H steps by 1.0, wildly wrong for
    ~0.02-std weights)."""
    return {n: a.reshape(1).repeat(int(history_len))
            for n, a in lowp_amax_tree(backbone).items()}


def lowp_history_step(hist: dict, backbone: torch.nn.Module) -> dict:
    """Advance every ring one step: drop the oldest amax, append the
    updated masters' (``record_function("lowp_amax")``)."""
    with torch.profiler.record_function("lowp_amax"):
        new = lowp_amax_tree(backbone)
        rings = torch.stack([hist[n] for n in new])
        rings = torch.cat([rings[:, 1:], torch.stack(list(new.values()))[:, None]], 1)
        return dict(zip(new, rings.unbind(0)))


def lowp_scales(hist: dict, arm: str, margin: float) -> dict:
    """History rings -> {weight name: delayed scale (0-d fp32)}."""
    if not hist:
        return {}
    scales = scale_from_history(torch.stack(list(hist.values())), qspec(arm).qmax, margin)
    return dict(zip(hist, scales.unbind(0)))


def lowp_state_step(lowp: dict, meta) -> dict:
    """Both models' rings advanced from their updated masters (the
    reference's ``train/fused_update.py lowp_state_step``)."""
    return {"student": lowp_history_step(lowp["student"], meta.student["backbone"]),
            "teacher": lowp_history_step(lowp["teacher"], meta.teacher["backbone"])}


@contextlib.contextmanager
def lowp_bound(backbone: torch.nn.Module, scales: dict | None, arm: str):
    """Bind each castable weight's scale to the module that owns its
    Linear for the duration (forward, and backward recomputation under
    activation checkpointing): ``module.lowp = (arm, {child: scale})``.
    Outside it every module runs its bf16 products (evals, serving)."""
    owners = {}
    for name, scale in (scales or {}).items():
        parent, child = lowp_scale_site(name)
        owners.setdefault(parent, {})[child] = scale
    mods = [backbone.get_submodule(p) for p in owners]
    for mod, (_, sc) in zip(mods, owners.items()):
        mod.lowp = (arm, sc)
    try:
        yield
    finally:
        for mod in mods:
            mod.lowp = None


# ---------------------------------------------------------------------
# the quantized product
# ---------------------------------------------------------------------

def _gather_codes(q: torch.Tensor) -> torch.Tensor:
    """The reference's ZeRO-3 stream of the codes; the identity at world
    size 1 (sharded masters wait, ROADMAP M7)."""
    return q


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    return torch.nn.functional.pad(t, (0, cols - c, 0, rows - r))


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def codes_matmul_plain(q_x: torch.Tensor, q_w: torch.Tensor, arm: str) -> torch.Tensor:
    """``q_x @ q_w.T`` of codes [M, K] x [N, K]: int8 summed exactly in
    float64 (every partial sum is an integer below 2^53) and returned as
    int32, the int32 accumulator's exact value; fp8 dequantized to fp32
    and multiplied (fp32 [M, N])."""
    if arm == "int8":
        return (q_x.double() @ q_w.double().t()).to(torch.int32)
    return q_x.float() @ q_w.float().t()


def codes_matmul(q_x: torch.Tensor, q_w: torch.Tensor, arm: str) -> torch.Tensor:
    """The codes' product on the device they lie on: the plain version on
    the CPU; on the card ``torch._int_mm`` (int32 out, M > 16, K and N
    multiples of 8) or ``torch._scaled_mm`` (unit scales, fp32 out, K and
    N multiples of 16, full-precision accumulation), padding with zero
    codes where a shape breaks those rules."""
    if q_x.device.type == "cpu":
        return codes_matmul_plain(q_x, q_w, arm)
    M, K = q_x.shape
    N = q_w.shape[0]
    if arm == "int8":
        Mp, Kp, Np = max(M, 17), _up(K, 8), _up(N, 8)
        acc = torch._int_mm(_pad_to(q_x, Mp, Kp), _pad_to(q_w, Np, Kp).t())
        return acc if (Mp, Np) == (M, N) else acc[:M, :N]
    Kp, Np = _up(K, 16), _up(N, 16)
    one = torch.ones((), dtype=torch.float32, device=q_x.device)
    acc = torch._scaled_mm(_pad_to(q_x, M, Kp), _pad_to(q_w, Np, Kp).t(),
                           scale_a=one, scale_b=one, out_dtype=torch.float32,
                           use_fast_accum=False)
    return acc[:, :N]


class _LowpMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, arm):
        spec = qspec(arm)
        scale = scale.detach().float()
        q_w = _gather_codes(quantize(w.detach(), scale, spec))
        s_x = current_scale(x, spec.qmax)
        q_x = quantize(x.detach(), s_x, spec)
        acc = codes_matmul(q_x.reshape(-1, x.shape[-1]), q_w, arm)
        with torch.profiler.record_function("lowp_dequant"):
            out = dequantize(acc, s_x * scale, x.dtype)
        ctx.save_for_backward(q_x, s_x, q_w, scale)
        ctx.dtypes = (x.dtype, w.dtype)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        q_x, s_x, q_w, scale = ctx.saved_tensors
        q_w = _gather_codes(q_w)
        w_hat = dequantize(q_w, scale, g.dtype)              # [N, K]
        x_hat = dequantize(q_x, s_x, g.dtype)                # [..., K]
        dx = g @ w_hat
        dw = g.reshape(-1, g.shape[-1]).t() @ x_hat.reshape(-1, x_hat.shape[-1])
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None


def lowp_matmul(arm: str, x: torch.Tensor, w: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` through the quantized arm: x [..., K] and w [N, K] in
    the compute dtype (the weight's bf16 view), ``scale`` the weight's
    delayed scale (0-d fp32). The bias, if any, is the caller's, added
    after. Straight-through backward (module docstring)."""
    return _LowpMatmul.apply(x, w, scale, arm)


def lowp_dense(module, child: str, x: torch.Tensor, bias: torch.Tensor | None,
               dtype: torch.dtype) -> torch.Tensor:
    """The product of ``module``'s Linear ``child`` in the compute dtype:
    through ``lowp_matmul`` while a scale is bound (``lowp_bound``), the
    legacy fp8 hook when ``module.fp8`` (``ops/common.py fp8_matmul``),
    else the bf16 ``dense``; ``bias`` (the Linear's, or a masked one) is
    added after the product."""
    from dinov3_tpu_torch.ops.common import dense, fp8_matmul

    weight = getattr(module, child).weight
    lp = getattr(module, "lowp", None)
    if lp is not None and child in lp[1]:
        y = lowp_matmul(lp[0], x.to(dtype), weight.to(dtype), lp[1][child])
    elif getattr(module, "fp8", False):
        y = fp8_matmul(x.to(dtype), weight.to(dtype))
    else:
        return dense(x, weight, bias, dtype)
    return y if bias is None else y + bias.to(dtype)


# ---------------------------------------------------------------------
# drift probe (configs/config.py warn_lowp_divergence)
# ---------------------------------------------------------------------

def lowp_drift_probe(backbone: torch.nn.Module, hist: dict, arm: str, margin: float,
                     seed: int = 0, probe=None) -> dict:
    """Per-weight drift of ``lowp_matmul`` against the bf16 product on
    block 0 of the stack: the relative Frobenius error on a fixed normal
    probe batch of 8 rows (``probe(K) -> [8, K]`` bf16, default seeded
    from ``seed``). Returns ``{"<owner>/<linear>": drift, ..., "max"}``."""
    scales = lowp_scales(hist, arm, margin)
    drifts: dict = {}
    with torch.no_grad():
        for name, p in _lowp_weights(backbone).items():
            if not name.startswith("blocks.0."):
                continue
            w = p.detach().to(torch.bfloat16)
            if probe is not None:
                x = probe(w.shape[1]).to(device=w.device, dtype=torch.bfloat16)
            else:
                gen = torch.Generator().manual_seed(seed)
                x = torch.randn(8, w.shape[1], generator=gen).to(w.device, torch.bfloat16)
            ref = (x @ w.t()).float()
            got = lowp_matmul(arm, x, w, scales[name]).float()
            denom = torch.linalg.vector_norm(ref).clamp_min(1e-12)
            parent, child = lowp_scale_site(name)
            drifts[f"{parent}/{child}"] = float(torch.linalg.vector_norm(got - ref) / denom)
    drifts["max"] = max([v for k, v in drifts.items() if k != "max"], default=0.0)
    return drifts
