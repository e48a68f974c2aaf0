"""Config system: YAML + dot-override merging onto an attribute-access dict
(the subset of ``dinov3_tpu/configs/config.py`` the serve and training
slices read).

The default schema is this package's copy of ``ssl_default_config.yaml``
(held equal to the JAX package's by the tests); a run YAML is merged on
top, then ``key.path=value`` overrides, then the batch-size lr scaling
(``apply_scaling_rules_to_cfg``) for an explicit device count. The JAX
loader's TPU guardrails (sublane tiling of row counts, collective bucket
padding, the tuned-plan checks) are speed rules of that chip and are not
carried over; ``check_train_slice`` holds a config to what the training
slice implements and names where each missing option waits.
"""

from __future__ import annotations

import ast
import copy
import os
import warnings
from pathlib import Path
from typing import Any, Iterable, Mapping

import yaml

_DEFAULT_YAML = Path(__file__).parent / "ssl_default_config.yaml"


class ConfigNode(dict):
    """A dict with attribute access and strict missing-key errors."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(f"config has no key {name!r}") from e
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigNode(copy.deepcopy(dict(self), memo))

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, ConfigNode) else (
                dict(v) if isinstance(v, dict) else v
            )
        return out


def _wrap(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return ConfigNode({k: _wrap(v) for k, v in tree.items()})
    return tree


def _merge(base: dict, overlay: Mapping) -> dict:
    """Recursively merge ``overlay`` onto ``base`` (overlay wins)."""
    for k, v in overlay.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), Mapping):
            _merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return base


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML-ish typing."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        try:
            return ast.literal_eval(text)
        except (ValueError, SyntaxError):
            return text


def apply_dot_overrides(cfg: ConfigNode, overrides: Iterable[str]) -> ConfigNode:
    """Apply ``a.b.c=value`` overrides in place; numeric components index
    lists. Strict against the schema: an unknown section or key raises
    unless the path is prefixed with ``+``."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key.path=value")
        path, _, raw = item.partition("=")
        path = path.strip()
        allow_new = path.startswith("+")
        if allow_new:
            path = path[1:]
        keys = path.split(".")
        node = cfg
        for depth, k in enumerate(keys[:-1]):
            if isinstance(node, list):
                node = node[int(k)]
                continue
            nxt = node.get(k)
            if isinstance(nxt, list):
                node = nxt
                continue
            if not isinstance(nxt, dict):
                if nxt is None and k not in node and not allow_new:
                    raise KeyError(
                        f"override {item!r}: unknown section "
                        f"{'.'.join(keys[:depth + 1])!r} (prefix with '+' "
                        "to add new keys)"
                    )
                if nxt is not None and not allow_new:
                    raise KeyError(
                        f"override {item!r}: "
                        f"{'.'.join(keys[:depth + 1])!r} is a value, not a "
                        "section (prefix with '+' to replace it with one)"
                    )
                nxt = ConfigNode()
                node[k] = nxt
            elif not isinstance(nxt, ConfigNode):
                nxt = ConfigNode(nxt)
                node[k] = nxt
            node = nxt
        leaf = keys[-1]
        value = _parse_value(raw.strip())
        if isinstance(node, list):
            node[int(leaf)] = value
        else:
            if not allow_new and leaf not in node:
                raise KeyError(
                    f"override {item!r}: unknown key {path!r} (prefix "
                    "with '+' to add new keys)"
                )
            if (not allow_new and isinstance(node.get(leaf), dict)
                    and not isinstance(value, dict)):
                raise KeyError(
                    f"override {item!r}: {path!r} is a section, not a "
                    "value (prefix with '+' to replace it)"
                )
            node[leaf] = value
    return cfg


def get_default_config() -> ConfigNode:
    with open(_DEFAULT_YAML) as f:
        return _wrap(yaml.safe_load(f))


def load_config(
    config_file: str | os.PathLike | None = None,
    overrides: Iterable[str] = (),
    *,
    n_devices: int = 1,
) -> ConfigNode:
    """default yaml <- run yaml <- dot overrides, then the lr scaling for
    ``n_devices`` devices (one card: 1)."""
    cfg = get_default_config().to_dict()
    if config_file:
        with open(config_file) as f:
            run_cfg = yaml.safe_load(f) or {}
        _merge(cfg, run_cfg)
    cfg = _wrap(cfg)
    # reference recipes use `train.batch_size_per_gpu`; accept it as an alias
    if "batch_size_per_gpu" in cfg.train:
        cfg.train.batch_size_per_device = cfg.train.pop("batch_size_per_gpu")
    apply_dot_overrides(cfg, overrides)
    cfg = apply_scaling_rules_to_cfg(cfg, n_devices)
    warn_accum_batch_tiling(cfg, n_devices)
    warn_telemetry_flush_period(cfg)
    warn_exposed_comm(cfg)
    warn_serve_cache_memory(cfg)
    return cfg


def data_parallel_world(cfg: ConfigNode, n_devices: int) -> int:
    """Devices holding independent batch shards: the model-parallel axes
    (tensor, seq, pipe, expert) replicate the batch and divide out."""
    replicas = 1
    par = cfg.get("parallel") or {}
    for axis in ("tensor", "seq", "pipe", "expert"):
        replicas *= int(par.get(axis, 1) or 1)
    return max(1, int(n_devices) // replicas)


def global_batch_size(cfg: ConfigNode, n_devices: int) -> int:
    return cfg.train.batch_size_per_device * data_parallel_world(cfg, n_devices)


def apply_scaling_rules_to_cfg(cfg: ConfigNode, n_devices: int) -> ConfigNode:
    """Batch-size lr scaling, once: ``linear_wrt_256`` lr *= B/256,
    ``sqrt_wrt_1024`` lr *= 4 * sqrt(B/1024), with B the global batch over
    ``n_devices``; skipped when a schedules-v2 block gives absolute ramps.
    The scaled lr is stored back and ``_lr_scaled`` set."""
    if cfg.get("_lr_scaled") or cfg.get("schedules"):
        return cfg
    rule = cfg.optim.scaling_rule
    B = global_batch_size(cfg, n_devices)
    if rule == "linear_wrt_256":
        cfg.optim.lr = cfg.optim.lr * B / 256.0
    elif rule == "sqrt_wrt_1024":
        cfg.optim.lr = cfg.optim.lr * 4.0 * (B / 1024.0) ** 0.5
    elif rule not in (None, "", "none"):
        raise ValueError(f"unknown scaling rule {rule!r}")
    cfg["_lr_scaled"] = True
    return cfg


def _wished(value, default_on: bool) -> bool:
    if isinstance(value, str):
        low = value.lower()
        if low == "auto":
            return default_on
        if low not in ("true", "false", "on", "off"):
            raise ValueError(f"expected auto/true/false, got {value!r}")
        return low in ("true", "on")
    return bool(value)


def streaming_targets_wished(cfg: ConfigNode) -> bool:
    """``loss.streaming_targets``: auto/true (default) = the streaming
    K-tiled CE (``losses/streaming.py``); false = materialized targets."""
    st = (cfg.get("loss") or {}).get("streaming_targets", "auto")
    if isinstance(st, str):
        low = st.lower()
        if low not in ("auto", "true", "false", "on", "off"):
            raise ValueError(f"loss.streaming_targets must be auto/true/false, got {st!r}")
        return low in ("auto", "true", "on")
    return bool(st)


def crop_packing_wished(cfg: ConfigNode) -> bool:
    """``model.crop_packing``: auto/true (default) = the crop-packed
    student pass; false = the two-pass student."""
    return _wished((cfg.get("model") or {}).get("crop_packing", "auto"), True)


def rng_plan_wished(cfg: ConfigNode) -> bool:
    """``rng.plan``: auto/true (default) = the step plan; false = the
    per-pass, per-block generators (``rng/plan.py fold_in_plan``)."""
    return _wished((cfg.get("rng") or {}).get("plan", "auto"), True)


def warn_accum_batch_tiling(cfg: ConfigNode, n_devices: int = 1,
                            stacklevel: int = 2) -> list[str]:
    """Warn while the config is still editable when ``optim.accum_steps``
    does not divide the global image batch: the crop-major microbatch
    split (``train/train_step.py split_microbatches``) needs equal image
    subsets and raises ``ValueError`` at the step. (The JAX package also
    warns about TPU sublane padding of the microbatch; that does not
    apply on the card.) Returns the messages ([] when accumulation is off
    or tiles)."""
    a = int((cfg.get("optim") or {}).get("accum_steps", 1) or 1)
    if a <= 1:
        return []
    b = global_batch_size(cfg, n_devices)
    if b % a == 0:
        return []
    msg = (f"optim.accum_steps axis: accum_steps={a} does not divide the global "
           f"image batch B={b} — the microbatch split "
           f"(train/train_step.py split_microbatches) will raise. Pick "
           f"accum_steps dividing B, or retune the batch.")
    warnings.warn(msg, stacklevel=stacklevel + 1)
    return [msg]


def check_train_slice(cfg: ConfigNode) -> None:
    """Refuse what the training slice does not implement, naming the
    ROADMAP item where it waits; nothing falls back quietly. Also the
    JAX meta-arch's own checks (local crops, iBOT head, mask ratios,
    centering, accumulation steps, the packing and plan flags). ``train.scan_layers``
    is an XLA compile option with no effect on the numbers: the port's
    block stack is unrolled whatever it says (the trainer logs it)."""
    if cfg.crops.local_crops_number <= 0:
        raise ValueError("DINOv3 needs local crops (crops.local_crops_number > 0)")
    if not cfg.ibot.separate_head:
        raise ValueError("only ibot.separate_head=true is supported")
    lo, hi = cfg.ibot.mask_ratio_min_max
    if not 0 <= lo < hi <= 1:
        raise ValueError("provide a valid ibot.mask_ratio_min_max")
    if cfg.optim.optimizer != "adamw":
        raise ValueError(f"unsupported optimizer {cfg.optim.optimizer!r}")
    if cfg.train.centering not in ("sinkhorn_knopp", "softmax_center"):
        raise ValueError(f"unknown centering {cfg.train.centering!r}")
    if int((cfg.get("optim") or {}).get("accum_steps", 1) or 1) < 1:
        raise ValueError(f"optim.accum_steps must be >= 1, got {cfg.optim.accum_steps}")
    streaming_targets_wished(cfg)  # raises on a bad value
    crop_packing_wished(cfg), rng_plan_wished(cfg)  # raise on bad values
    distill_teacher_source(cfg)  # raises on a bad value
    s = cfg.student
    par = cfg.get("parallel") or {}
    sharded = {axis: int(par.get(axis, 1) or 1) for axis in
               ("fsdp", "tensor", "seq", "pipe", "expert", "dcn_data")}
    waits = [
        (any(n > 1 for n in sharded.values()),
         "parallel." + ", parallel.".join(f"{a}={n}" for a, n in sharded.items()
                                         if n > 1)
         + ": sharded and model-parallel meshes wait (ROADMAP M7, M8); the "
         "port trains on one card, set each to 1"),
    ]
    for refused, msg in waits:
        if refused:
            raise NotImplementedError(msg)
    check_lowp_arm(cfg)


def check_lowp_arm(cfg: ConfigNode) -> None:
    """The arm conflicts of ``dinov3_tpu/train/setup.py``: an fp8/int8
    ``train.low_precision.arm`` with ``student.fp8_enabled`` (both would
    quantize the same block matmuls) or with ``ffn_layer=moe`` (the expert
    products are not castable Dense kernels) raises ``ValueError``. MoE
    itself is refused at the model (ROADMAP M12)."""
    lp = lowp_cfg(cfg)
    if lp["arm"] == "bf16":
        return
    s = cfg.student
    if bool(s.get("fp8_enabled", False)):
        raise ValueError(
            f"train.low_precision.arm={lp['arm']!r} conflicts with "
            "student.fp8_enabled=true: both would quantize the same block "
            "matmuls (the legacy fp8 hook uses current per-tensor scaling, "
            "the lowp arms delayed scaling). Pick one — arm=fp8 supersedes "
            "fp8_enabled.")
    if str(s.get("ffn_layer", "mlp")) == "moe":
        raise ValueError(
            f"train.low_precision.arm={lp['arm']!r} does not support "
            "student.ffn_layer=moe: the expert products are not castable "
            "Dense kernels (ops/lowp.py lowp_kernel_path).")


def lowp_cfg(cfg: ConfigNode) -> dict:
    """The resolved ``train.low_precision`` block (``ops/lowp.py``): ``arm``
    (bf16, the unchanged path | fp8 | int8), ``amax_history_len`` (the
    delayed-scaling ring length), ``scale_margin`` (headroom on the
    history's amax) and ``divergence_tol`` (``warn_lowp_divergence``'s
    gate). An unknown arm raises: a typo never trains bf16 quietly."""
    lp = (cfg.get("train") or {}).get("low_precision") or {}
    arm = str(lp.get("arm", "bf16") or "bf16")
    from dinov3_tpu_torch.ops.lowp import LOWP_ARMS

    if arm not in LOWP_ARMS:
        raise ValueError(f"train.low_precision.arm={arm!r}: expected one of {LOWP_ARMS}")
    return {
        "arm": arm,
        "amax_history_len": int(lp.get("amax_history_len", 16) or 16),
        "scale_margin": float(lp.get("scale_margin", 1.0) or 1.0),
        "divergence_tol": float(lp.get("divergence_tol", 0.2) or 0.2),
    }


def warn_lowp_divergence(drift: float, tol: float = 0.2, stacklevel: int = 2,
                         axis: str = "lowp train matmuls") -> str | None:
    """Warn when the measured lowp-vs-bf16 matmul drift (``ops/lowp.py
    lowp_drift_probe``: relative Frobenius error on a sampled layer)
    exceeds ``train.low_precision.divergence_tol``. Fired at training
    set-up; returns the message, or None inside the band."""
    if drift <= tol:
        return None
    msg = (
        f"lowp divergence axis [{axis}]: measured quantized-matmul "
        f"drift {drift:.4g} vs the bf16 shadow exceeds "
        f"train.low_precision.divergence_tol={tol:.4g} — delayed "
        f"scaling cannot represent these kernels at this arm's "
        f"precision. Train this config in bf16 "
        f"(train.low_precision.arm=bf16), raise scale_margin, or raise "
        f"the tolerance only with a pinned loss-trajectory check.")
    warnings.warn(msg, stacklevel=stacklevel + 1)
    return msg


def anatomy_wished(cfg: ConfigNode) -> bool:
    """Whether the config asks for the step-anatomy ledger of the
    ``--profile-steps`` window (``telemetry.anatomy``: auto/true, the
    default, = parse and emit; false = the raw trace only)."""
    t = (cfg.get("telemetry") or {}).get("anatomy", "auto")
    if isinstance(t, str):
        return t.lower() in ("auto", "true", "on")
    return bool(t)


def warn_telemetry_flush_period(cfg: ConfigNode, stacklevel: int = 2) -> str | None:
    """Warn when ``telemetry.flush_every`` exceeds the checkpoint period
    or the eval period: rows still in the device ring at a restart are
    dropped, and the non-finite abort lags by up to a window
    (``telemetry/ring.py``). Fired by ``load_config``; returns the
    message, or None when the window fits or the ring is off."""
    from dinov3_tpu_torch.telemetry import telemetry_wished

    if not telemetry_wished(cfg):
        return None
    flush_every = int((cfg.get("telemetry") or {}).get("flush_every", 50))
    offenders = []
    ckpt_period = int(cfg.checkpointing.period)
    if ckpt_period > 0 and flush_every > ckpt_period:
        offenders.append(f"checkpointing.period={ckpt_period}")
    eval_period = int(cfg.evaluation.get("eval_period_iterations", 0) or 0)
    if eval_period > 0 and flush_every > eval_period:
        offenders.append(f"evaluation.eval_period_iterations={eval_period}")
    if not offenders:
        return None
    msg = (
        f"telemetry flush window: telemetry.flush_every={flush_every} "
        f"exceeds {' and '.join(offenders)} — metrics rows still in the "
        f"on-device ring at a restart are dropped, and the non-finite "
        f"abort lags by up to a full window (telemetry/ring.py). Lower "
        f"telemetry.flush_every, or set telemetry.async_metrics=false "
        f"for the per-step-fetch oracle.")
    warnings.warn(msg, stacklevel=stacklevel + 1)
    return msg


def warn_exposed_comm(cfg: ConfigNode, summary: dict | None = None,
                      stacklevel: int = 2) -> str | None:
    """Warn when a measured anatomy ``summary`` (``ledger_summary``)
    shows more exposed collective time than ``telemetry.exposed_comm_tol``
    allows, naming the worst scopes; without ``summary`` (``load_config``)
    check that the tolerance is a fraction in (0, 1]. Returns the message,
    or None."""
    tol = (cfg.get("telemetry") or {}).get("exposed_comm_tol", 0.25)
    try:
        tol = float(tol)
    except (TypeError, ValueError):
        tol = -1.0
    if summary is None:
        if 0.0 < tol <= 1.0:
            return None
        msg = (
            f"exposed-comm tolerance: telemetry.exposed_comm_tol={tol!r} "
            f"is not a fraction in (0, 1] — the anatomy guardrail "
            f"compares measured exposed-collective device time against "
            f"it (telemetry/anatomy.py); set e.g. 0.25.")
        warnings.warn(msg, stacklevel=stacklevel + 1)
        return msg
    if not anatomy_wished(cfg):
        return None
    frac = float(summary.get("exposed_comm_frac", 0.0) or 0.0)
    if frac <= tol:
        return None
    scopes = sorted((summary.get("collectives") or {}).items(),
                    key=lambda kv: -kv[1].get("exposed_ms_per_step", 0.0))[:3]
    worst = ", ".join(
        f"{name}={ent.get('exposed_ms_per_step', 0.0):.2f}ms/step "
        f"(overlap {ent.get('overlap_frac', 0.0):.0%})"
        for name, ent in scopes if ent.get("exposed_ms_per_step", 0.0) > 0
    ) or "no per-scope breakdown"
    msg = (
        f"exposed comm: measured exposed-collective fraction "
        f"{frac:.1%} of device-busy time exceeds "
        f"telemetry.exposed_comm_tol={tol:g} — the overlap schedule is "
        f"not hiding its communication (worst scopes: {worst}).")
    warnings.warn(msg, stacklevel=stacklevel + 1)
    return msg


def setup_job(cfg: ConfigNode) -> None:
    """Create the output directory, dump the resolved config there as
    ``config.yaml`` and seed the process's ``random`` and ``np.random``
    from ``train.seed`` (process-wide: an entry point's ``main`` calls it)."""
    import random

    import numpy as np

    out = Path(cfg.train.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    dump = {k: v for k, v in cfg.to_dict().items() if not k.startswith("_")}
    with open(out / "config.yaml", "w") as f:
        yaml.safe_dump(dump, f, sort_keys=False)
    random.seed(cfg.train.seed)
    np.random.seed(cfg.train.seed)


def continuous_packing_wished(cfg: ConfigNode) -> bool:
    """``serve.continuous_packing``: auto/true (default) = the packed
    engine; false = the per-shape oracle engine."""
    cp = (cfg.get("serve") or {}).get("continuous_packing", "auto")
    if isinstance(cp, str):
        return cp.lower() in ("auto", "true", "on")
    return bool(cp)


def serve_patch_features_wished(cfg: ConfigNode) -> bool:
    """``serve.patch_features``: opt-in per-token feature serving."""
    pf = (cfg.get("serve") or {}).get("patch_features", False)
    if isinstance(pf, str):
        return pf.lower() in ("true", "on", "1")
    return bool(pf)


def serve_pad_waste_floor(
    row_tokens: int, patch_size: int, n_prefix: int,
    min_px: int, max_px: int,
) -> dict:
    """Worst-case per-row pad waste over the serve resolution envelope.

    A square image of r px spans ``n_prefix + (r/p)^2`` tokens; a row
    holds ``row_tokens // that`` of them and wastes the remainder. Returns
    the worst ``{"px", "seq_len", "waste"}`` over the envelope plus
    ``"mean_waste"``, the waste averaged uniformly over it."""
    worst = {"px": min_px, "seq_len": 0, "waste": 0.0}
    wastes = []
    for px in range(min_px, max_px + 1, patch_size):
        if px % patch_size:
            continue
        seq = n_prefix + (px // patch_size) ** 2
        if seq > row_tokens:
            continue
        waste = 1.0 - (row_tokens // seq) * seq / row_tokens
        wastes.append(waste)
        if waste > worst["waste"]:
            worst = {"px": px, "seq_len": seq, "waste": waste}
    worst["mean_waste"] = sum(wastes) / len(wastes) if wastes else 0.0
    return worst


def warn_serve_pad_waste(
    pad_waste: float, threshold: float = 0.15, stacklevel: int = 2,
    axis: str = "serve token budget",
) -> str | None:
    """Warn when a serve mix (or the envelope's floor) spends more than
    ``threshold`` of the token budget on padding. Returns the message or
    None."""
    if pad_waste <= threshold:
        return None
    msg = (
        f"serve pad-waste axis [{axis}]: {pad_waste:.1%} of the packed "
        f"token budget is padding (> {threshold:.0%}) — the serve step "
        f"spends that fraction of its FLOPs on masked-out tokens. Resize "
        f"serve.row_tokens / serve.rows to the traffic's token "
        f"distribution, or tighten the serve.min_px..max_px envelope."
    )
    warnings.warn(msg, stacklevel=stacklevel + 1)
    return msg


def serve_obs_wished(cfg: ConfigNode) -> bool:
    """``telemetry.serve_spans``: auto/true (default) = the serving
    observability plane (``telemetry/serve_obs.py``) behind the engines;
    false = serving without it."""
    t = (cfg.get("telemetry") or {}).get("serve_spans", "auto")
    if isinstance(t, str):
        return t.lower() in ("auto", "true", "on")
    return bool(t)


def serve_obs_kwargs(cfg: ConfigNode) -> dict:
    """The ``telemetry.serve_*`` block as ``ServeObserver`` kwargs."""
    t = cfg.get("telemetry") or {}
    return {
        "window_packs": int(t.get("serve_window_packs", 16) or 16),
        "hist_lo_ms": float(t.get("serve_hist_lo_ms", 1e-2) or 1e-2),
        "hist_hi_ms": float(t.get("serve_hist_hi_ms", 1e5) or 1e5),
        "bins_per_decade": int(
            t.get("serve_hist_bins_per_decade", 16) or 16),
        "mix_alpha": float(t.get("serve_mix_alpha", 0.25) or 0.25),
        "window_deadline_s": float(
            t.get("serve_window_deadline_s", 0.0) or 0.0),
    }


def serve_quant_wished(cfg: ConfigNode) -> bool:
    """``serve.quant.enabled``: opt-in int8 serving weights
    (``serve/quant.py``); a fleet engine's own ``quant`` overrides it."""
    q = (cfg.get("serve") or {}).get("quant") or {}
    e = q.get("enabled", False)
    if isinstance(e, str):
        return e.lower() in ("true", "on", "1")
    return bool(e)


def serve_cache_wished(cfg: ConfigNode) -> bool:
    """``serve.cache.enabled``: auto/true (default) = the fleet's
    content-addressed feature cache (``serve/cache.py``); frozen weights
    make a hit bitwise its miss."""
    c = (cfg.get("serve") or {}).get("cache") or {}
    e = c.get("enabled", "auto")
    if isinstance(e, str):
        return e.lower() in ("auto", "true", "on")
    return bool(e)


def distill_teacher_source(cfg: ConfigNode) -> str:
    """``distillation.teacher_source``, where the frozen teacher's
    features come from under distillation:

    - ``in_step`` (default): the teacher backbone forwards inside the
      train step, the oracle the serve arm is held against;
    - ``serve``: the process-shared packed teacher engine
      (``train/distillation.py TeacherServer``) computes the CLS and patch
      features once per image, its content-addressed cache absorbs
      repeats, and the step reads them from the batch's ``teacher_cls`` /
      ``teacher_patches`` planes (``SSLMetaArch.get_teacher_output``).

    Anything else raises ``ValueError``."""
    d = cfg.get("distillation") or {}
    ts = str(d.get("teacher_source", "in_step") or "in_step").lower()
    if ts not in ("in_step", "serve"):
        raise ValueError(
            f"distillation.teacher_source={ts!r}: expected in_step|serve")
    return ts


def serve_cache_entry_bytes(embed_dim: int, patch_tokens: int = 0) -> int:
    """Feature bytes of one cache entry: the CLS and pooled [D] fp32
    vectors, plus a [T, D] fp32 patch plane when per-token features are
    served (``patch_tokens`` = T)."""
    return (2 + int(patch_tokens)) * int(embed_dim) * 4


def warn_quant_drift(
    drift: float, tol: float = 0.05, stacklevel: int = 2,
    axis: str = "int8 serving model",
) -> str | None:
    """Warn when the measured int8 CLS feature drift against the bf16
    model exceeds ``serve.quant.drift_tol``. Returns the message or
    None."""
    if drift <= tol:
        return None
    msg = (
        f"quant drift axis [{axis}]: measured int8 CLS feature drift "
        f"{drift:.4g} exceeds serve.quant.drift_tol={tol:.4g} — the "
        f"quantized engine's features have left the bf16 model's "
        f"tolerance band. Serve this model in bf16 "
        f"(serve.quant.enabled=false or the engine overlay's "
        f"quant=false), or raise the tolerance only with a downstream "
        f"quality check."
    )
    warnings.warn(msg, stacklevel=stacklevel + 1)
    return msg


def warn_cache_memory(
    capacity: int, embed_dim: int, budget_mb: float = 1024.0,
    threshold: float = 1.0, stacklevel: int = 2,
    axis: str = "serve feature cache", patch_tokens: int = 0,
) -> str | None:
    """Warn when the cache's worst-case feature bytes (capacity x
    ``serve_cache_entry_bytes``) exceed ``threshold`` x the host budget
    (``serve.cache.host_budget_mb``). Returns the message or None."""
    entry = serve_cache_entry_bytes(embed_dim, patch_tokens)
    need_mb = int(capacity) * entry / 2**20
    if budget_mb <= 0 or need_mb <= threshold * budget_mb:
        return None
    msg = (
        f"cache memory axis [{axis}]: serve.cache.capacity={capacity} "
        f"x {entry} B/entry (embed_dim {embed_dim}, patch_tokens "
        f"{patch_tokens}) = {need_mb:.0f} MB of feature payload at full "
        f"occupancy, over the serve.cache.host_budget_mb={budget_mb:.0f} "
        f"budget. Lower the capacity or raise the budget "
        f"(serve/cache.py)."
    )
    warnings.warn(msg, stacklevel=stacklevel + 1)
    return msg


def warn_serve_cache_memory(cfg: ConfigNode, stacklevel: int = 2) -> str | None:
    """``warn_cache_memory`` at ``load_config``: the configured arch's
    width (read off a parameterless ``meta``-device build) against the
    cache's capacity and budget, when the cache is wished. Configs that
    cannot build a backbone are skipped: this is a guardrail, not a
    gate."""
    if not serve_cache_wished(cfg):
        return None
    c = (cfg.get("serve") or {}).get("cache") or {}
    budget_mb = float(c.get("host_budget_mb", 1024) or 1024)
    if budget_mb <= 0:
        return None
    try:
        import torch

        from dinov3_tpu_torch.models import ARCHS, backbone_kwargs_from_cfg

        with torch.device("meta"):
            embed_dim = ARCHS[cfg.student.arch](
                **backbone_kwargs_from_cfg(cfg)).embed_dim
    except (KeyError, ValueError, NotImplementedError):
        return None
    return warn_cache_memory(
        int(c.get("capacity", 4096) or 4096), embed_dim,
        budget_mb=budget_mb, stacklevel=stacklevel + 1)
