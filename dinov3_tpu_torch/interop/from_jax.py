"""JAX backbone parameter tree -> the port's ``state_dict``.

The JAX package's tree (nested dicts of arrays, e.g. from
``flax.core.unfreeze(params)`` turned into numpy) is renamed to Meta's
``state_dict`` names, which the port's modules carry: the key table of
``dinov3_tpu/interop/torch_convert.py`` read in reverse. Transposes:
Dense kernels [in, out] -> [out, in] (qkv [D, 3D] -> [3D, D]), the patch
kernel [p, p, C, D] -> [D, C, p, p], and the mask token [D] -> [1, D].
Both the unscanned (``blocks_N``) and the scanned (``blocks/block`` with
[L, ...] stacked leaves) trees are taken.

The training tree ``{"student": {backbone, dino_head, ibot_head},
"teacher": {...}}`` maps onto ``SSLMetaArch``'s ``student`` and
``teacher`` modules (``meta_state_dicts_from_jax``): the heads take Meta's
names, ``mlp_i`` -> ``mlp.{2i}`` (the Linear layers between the GELUs)
and ``prototypes`` [bottleneck, K] -> ``last_layer.weight`` [K,
bottleneck]. A gradient tree of the same structure maps the same way.

``train_state_from_jax`` takes the leaves of a whole JAX ``TrainState``
keyed by their ``jax.tree_util.keystr`` paths (the JAX package's local-npz
checkpoint) and returns the student, the teacher, the Adam moments (keyed
by the student's names), the update count, the step and, from an fp8 /
int8 run, the amax rings (``lowp_rings_from_jax``);
``teacher_backbone_from_jax`` takes only the EMA teacher's backbone (what
the evals and serving restore). bf16 leaves that
``np.savez`` stored as 2-byte void records are read as bf16 by their bits.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_BLOCK_LEAF = {
    ("attn", "qkv_kernel"): ("attn.qkv.weight", True),
    ("attn", "qkv_bias"): ("attn.qkv.bias", False),
    ("attn", "proj_kernel"): ("attn.proj.weight", True),
    ("attn", "proj_bias"): ("attn.proj.bias", False),
}


def _flatten(tree: Mapping, prefix=()) -> dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _block_key(path: tuple) -> tuple[str, bool]:
    """Path inside one block -> (Meta name, transpose?)."""
    if path in _BLOCK_LEAF:
        return _BLOCK_LEAF[path]
    *mods, leaf = path
    name = ".".join(mods)
    if leaf == "scale":  # norm1 / norm2
        return f"{name}.weight", False
    if leaf == "kernel":  # mlp.fc1 / mlp.fc2, SwiGLU mlp.w12 / mlp.w3
        return f"{name}.weight", True
    return f"{name}.{leaf}", False  # biases, ls1/ls2 gamma


def _top_key(path: tuple) -> tuple[str, str]:
    """Top-level path -> (Meta name, how to reshape)."""
    if path == ("patch_embed", "kernel"):
        return "patch_embed.proj.weight", "patch"
    if path == ("patch_embed", "bias"):
        return "patch_embed.proj.bias", "none"
    if path == ("mask_token",):
        return "mask_token", "row"
    *mods, leaf = path
    if leaf == "scale":  # norm / cls_norm / local_cls_norm
        return ".".join(mods) + ".weight", "none"
    return ".".join(path), "none"


def _to_torch(value, transpose=False) -> torch.Tensor:
    a = np.asarray(value)
    if transpose:
        a = a.T
    a = np.array(a, order="C")  # a writable, contiguous copy
    # numpy has no bf16: move the bits (of an ml_dtypes array, or of the
    # 2-byte void records np.savez writes for one)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def head_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``DINOHead`` params -> the port's ``DINOHead`` ``state_dict``."""
    out = {}
    for path, value in _flatten(params).items():
        if path == ("prototypes",):
            out["last_layer.weight"] = _to_torch(value, transpose=True)
            continue
        m = re.fullmatch(r"mlp_(\d+)", path[0])
        if m is None or len(path) != 2 or path[1] not in ("kernel", "bias"):
            raise KeyError(f"unknown DINOHead leaf {'/'.join(path)}")
        name = f"mlp.{2 * int(m.group(1))}.{'weight' if path[1] == 'kernel' else 'bias'}"
        out[name] = _to_torch(value, transpose=path[1] == "kernel")
    return out


def meta_state_dicts_from_jax(params: Mapping) -> dict[str, dict]:
    """The JAX training tree {"student": ..., "teacher": ...} (each
    {backbone, dino_head, ibot_head}) -> {"student": state_dict,
    "teacher": state_dict} for ``SSLMetaArch.student`` / ``.teacher``."""
    out = {}
    for role, sub in params.items():
        sd = {f"backbone.{k}": v
              for k, v in state_dict_from_jax(sub["backbone"]).items()}
        for head in ("dino_head", "ibot_head"):
            sd.update({f"{head}.{k}": v for k, v in
                       head_state_dict_from_jax(sub[head]).items()})
        out[role] = sd
    return out


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """Nested JAX backbone params -> flat Meta-named torch ``state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def put(name, value, transpose=False):
        out[name] = _to_torch(value, transpose)

    for path, value in _flatten(params).items():
        m = re.fullmatch(r"blocks_(\d+)", path[0])
        if m:
            name, tr = _block_key(path[1:])
            put(f"blocks.{m.group(1)}.{name}", value, tr)
        elif path[:2] == ("blocks", "block"):
            name, tr = _block_key(path[2:])
            stacked = np.asarray(value)
            for i in range(stacked.shape[0]):
                put(f"blocks.{i}.{name}", stacked[i], tr)
        else:
            name, how = _top_key(path)
            a = np.asarray(value)
            if how == "patch":
                a = a.transpose(3, 2, 0, 1)  # [p, p, C, D] -> [D, C, p, p]
            elif how == "row":
                a = a.reshape(1, -1)
            put(name, a)
    return out


_KEY_PART = re.compile(r"\.(\w+)|\['([^']*)'\]|\[(\d+)\]")


def keystr_path(key: str) -> tuple[str, ...]:
    """A ``jax.tree_util.keystr`` path (``.params['student']['backbone']``,
    ``.opt_state.adam.count``) -> its names."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            break
        parts.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"not a keystr path: {key!r}")
    return tuple(parts)


def _keystr_tree(flat: Mapping[str, Any]) -> dict:
    """``{keystr path: leaf}`` -> the nested tree of those paths."""
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = keystr_path(key)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


TEACHER_BACKBONE = ("params", "teacher", "backbone")


def teacher_backbone_from_jax(flat: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The EMA teacher's backbone of a JAX ``TrainState`` (``{keystr path:
    array}``, other leaves ignored) -> the backbone's Meta-named
    ``state_dict``."""
    tree = _keystr_tree({k: v for k, v in flat.items()
                         if keystr_path(k)[:3] == TEACHER_BACKBONE})
    if not tree:
        raise KeyError("no params['teacher']['backbone'] leaves in the JAX state")
    return state_dict_from_jax(tree["params"]["teacher"]["backbone"])


def train_state_from_jax(flat: Mapping[str, Any]) -> dict:
    """Leaves of a JAX ``TrainState`` (``{keystr path: array}``) -> {"student":
    state_dict, "teacher": state_dict, "mu": {name: tensor}, "nu": {...},
    "center_state": {"dino_center", "ibot_center"}, "count": int, "step":
    int}, names those of ``SSLMetaArch.student``. The scheduled AdamW keeps
    the schedule index (``opt_state.count``) and Adam's bias-correction
    count (``opt_state.adam.count``) apart; the port keeps one count for
    both, so they must agree. The fp8/int8 amax rings come as "lowp"
    (``lowp_rings_from_jax``) when the state holds them. A Gram teacher is
    refused (ROADMAP M2)."""
    tree = _keystr_tree(flat)
    params, opt = tree["params"], tree["opt_state"]
    if set(params) != {"student", "teacher"}:
        raise NotImplementedError(
            f"JAX checkpoint with params {sorted(params)}: only the student "
            "and teacher are ported (the Gram teacher waits, ROADMAP M2)")
    count, adam_count = int(np.asarray(opt["count"])), int(np.asarray(opt["adam"]["count"]))
    if count != adam_count:
        raise ValueError(f"schedule count {count} != Adam count {adam_count}")
    out = meta_state_dicts_from_jax({"student": params["student"],
                                     "teacher": params["teacher"]})
    moments = meta_state_dicts_from_jax({"mu": opt["adam"]["mu"],
                                         "nu": opt["adam"]["nu"]})
    centers = {k: _to_torch(v, False) for k, v in tree["center_state"].items()}
    lowp = ({k: lowp_rings_from_jax(v) for k, v in tree["lowp"].items()}
            if isinstance(tree.get("lowp"), Mapping) else {})
    return {**out, **moments, "center_state": centers, "count": count,
            "step": int(np.asarray(tree["step"])), **({"lowp": lowp} if lowp else {})}


def lowp_rings_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """One model's JAX amax history rings (``TrainState.lowp["student"]``:
    fp32 [H] at each kernel's scale site, ``blocks_N/attn/qkv_kernel``,
    ``blocks_N/mlp/fc1_kernel``; or [L, H] under the scanned
    ``blocks/block``) -> {the port's weight name: fp32 [H]}, e.g.
    ``blocks.N.attn.qkv.weight``, ``blocks.N.mlp.fc1.weight``."""
    out = {}
    for path, value in _flatten(tree).items():
        *parent, leaf = path
        if not leaf.endswith("_kernel") or len(parent) < 2:
            raise KeyError(f"not a lowp ring site: {'/'.join(path)}")
        site = f"{parent[-1]}.{leaf[: -len('_kernel')]}.weight"
        a = np.asarray(value, np.float32)
        m = re.fullmatch(r"blocks_(\d+)", parent[0])
        if m and len(parent) == 2:
            out[f"blocks.{m.group(1)}.{site}"] = torch.from_numpy(a.copy())
        elif tuple(parent[:2]) == ("blocks", "block") and len(parent) == 3:
            for i in range(a.shape[0]):
                out[f"blocks.{i}.{site}"] = torch.from_numpy(a[i].copy())
        else:
            raise KeyError(f"not a lowp ring site: {'/'.join(path)}")
    return out


def quant_state_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX int8 serving tree (``quantize_serving_tree``: ``QuantLeaf``
    (q, scale) pairs at the matmul kernels, as numpy) -> the port's int8
    ``state_dict`` (``serve/quant.py``): each quantized kernel's Meta name
    ``<m>.weight`` becomes ``<m>.q`` (int8 codes [out, in], the JAX codes
    transposed) and ``<m>.scale`` (fp32 [out, 1]); every other leaf maps
    as ``state_dict_from_jax`` maps it."""

    def is_quant(v) -> bool:
        return hasattr(v, "q") and hasattr(v, "scale")

    def pick(tree, field):
        return {k: pick(v, field) if isinstance(v, Mapping)
                else np.asarray(getattr(v, field)) if is_quant(v) else v
                for k, v in tree.items()}

    codes = state_dict_from_jax(pick(params, "q"))
    scales = state_dict_from_jax(pick(params, "scale"))
    out = {}
    for name, t in codes.items():
        if t.dtype == torch.int8:
            base = name[: -len(".weight")]
            out[f"{base}.q"] = t
            out[f"{base}.scale"] = scales[name]
        else:
            out[name] = t
    return out
