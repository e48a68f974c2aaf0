"""Distillation from a frozen teacher of its own architecture
(``dinov3_tpu/train/distillation.py``).

The teacher's config is its own recipe (``distillation.full_cfg_path``,
``resolve_distillation_cfg``); its weights come from a checkpoint of its
own training run (``distillation.checkpoint_path``, ``load_teacher_params``:
the run's EMA teacher, backbone and heads) or from the seeded draw. It
never trains: no gradient, no optimizer state, no EMA.

Under ``distillation.teacher_source=serve`` the step does not forward the
teacher. ``TeacherServer`` runs it once per image through the packed
serve engine (``serve/engine.py``, per-token features on) behind the
content-addressed feature cache (``serve/cache.py``), and the trainer
hands the step its features as the batch's ``teacher_cls`` /
``teacher_patches`` planes (``TeacherServer.annotate``);
``teacher_feature_example`` gives zero planes of those shapes.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from dinov3_tpu_torch.configs import ConfigNode, load_config
from dinov3_tpu_torch.logging_utils import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME)


def resolve_distillation_cfg(cfg: ConfigNode) -> ConfigNode:
    """The frozen teacher's config (default <- teacher yaml). Raises
    ``ValueError`` without a path, without ``ibot.separate_head``, or when
    the prototype counts or the patch size differ from the student's."""
    path = cfg.distillation.full_cfg_path
    if not path:
        raise ValueError(
            "distillation.enabled=true requires distillation.full_cfg_path")
    teacher_cfg = load_config(path)
    if not teacher_cfg.ibot.separate_head:
        raise ValueError("distillation teacher must use ibot.separate_head")
    for section in ("dino", "ibot"):
        t = teacher_cfg[section]["head_n_prototypes"]
        s = cfg[section]["head_n_prototypes"]
        if t != s:
            raise ValueError(
                f"{section}.head_n_prototypes mismatch: teacher {t} vs "
                f"student {s} (losses share the prototype space)")
    if teacher_cfg.student.patch_size != cfg.student.patch_size:
        raise ValueError(
            "teacher and student patch_size must match "
            f"({teacher_cfg.student.patch_size} vs {cfg.student.patch_size})")
    logger.info("distillation teacher config: %s", path)
    return teacher_cfg


@torch.no_grad()
def load_teacher_params(cfg: ConfigNode, state):
    """The frozen teacher <- the teacher branch (backbone and heads: the
    EMA weights DINOv3 evaluates and distils from) of the newest finalized
    step under ``distillation.checkpoint_path``, a checkpoint directory of
    the teacher's own run (this package's, or the JAX package's local-npz
    one; orbax directories raise, ROADMAP M5), loaded strictly in place.
    A no-op when the path is unset."""
    path = cfg.distillation.checkpoint_path
    if not path:
        return state
    from dinov3_tpu_torch.checkpoint import params_state_dicts

    step, sds = params_state_dicts(path, branches=("teacher",))
    if "teacher" not in sds:
        raise KeyError(f"no teacher branch in the checkpoint under {path}")
    state.meta.teacher.load_state_dict(sds["teacher"], strict=True)
    logger.info("loaded distillation teacher from %s step %d", path, step)
    return state


def teacher_feature_example(cfg: ConfigNode, n_rows: int,
                            teacher_cfg: ConfigNode | None = None) -> dict:
    """Zero planes of the serve arm's batch shapes, ``teacher_cls``
    [n_rows, D_t] and ``teacher_patches`` [n_rows, T, D_t] fp32: the
    set-up's example batch and the self-check's, without a
    ``TeacherServer``. ``n_rows`` is the 2B global-crop rows; T is the
    student run's global crop grid (the patch size is shared), D_t the
    teacher's width (read off a parameterless ``meta`` build)."""
    from dinov3_tpu_torch.models import backbone_kwargs_from_cfg, vit_ctor

    if teacher_cfg is None:
        teacher_cfg = resolve_distillation_cfg(cfg)
    with torch.device("meta"):
        d = int(vit_ctor(teacher_cfg)(**backbone_kwargs_from_cfg(teacher_cfg)).embed_dim)
    t = (int(cfg.crops.global_crops_size) // int(cfg.student.patch_size)) ** 2
    return {"teacher_cls": np.zeros((n_rows, d), np.float32),
            "teacher_patches": np.zeros((n_rows, t, d), np.float32)}


class TeacherServer:
    """The process-shared frozen teacher: one packed serve engine
    (``patch_features=True``: the iBOT loss needs per-token features) and
    its content-addressed feature cache, in front of every student of
    this process (``multidistillation.shared_teacher_server``).

    ``annotate`` adds a batch's teacher planes: a cache miss goes through
    the engine (a duplicate within a batch forwards once), a hit replays
    the stored planes bitwise (frozen weights make that safe,
    ``serve/cache.py``). ``teacher_forwards`` counts images forwarded,
    ``requests`` images asked for.

    ``teacher_params`` is the teacher backbone's ``state_dict`` (a
    training state's, on the card: the serving model is cast there), else
    ``ckpt_dir`` names a checkpoint directory whose EMA teacher backbone
    it serves. The engine serves exactly the student run's global crop
    size (``serve.min_px = serve.max_px``), so the row budget fits two
    crops a row."""

    def __init__(self, cfg: ConfigNode, teacher_params: dict | None = None,
                 ckpt_dir: str | None = None, capacity: int | None = None,
                 warn: bool = True, device="cuda"):
        from dinov3_tpu_torch.configs.config import warn_cache_memory
        from dinov3_tpu_torch.serve.cache import FeatureCache, weights_fingerprint
        from dinov3_tpu_torch.serve.engine import PackedServeEngine, serve_layout_from_cfg
        from dinov3_tpu_torch.serve.weights import load_serving_model

        teacher_cfg = resolve_distillation_cfg(cfg)
        s = int(cfg.crops.global_crops_size)
        teacher_cfg.serve.min_px = s
        teacher_cfg.serve.max_px = s
        model = load_serving_model(teacher_cfg, teacher_params, ckpt_dir=ckpt_dir,
                                   device=device)
        # flush_ms=0: annotate drains the queue per batch; there is no
        # latency deadline to trade
        self.engine = PackedServeEngine(model, serve_layout_from_cfg(teacher_cfg),
                                        flush_ms=0.0, warn=warn, patch_features=True)
        self.fingerprint = weights_fingerprint(model)
        self.patch_grid = s // int(cfg.student.patch_size)
        cap = int(capacity or cfg.distillation.get("cache_capacity", 4096) or 4096)
        self.cache = FeatureCache(cap)
        if warn:
            c = (cfg.get("serve") or {}).get("cache") or {}
            warn_cache_memory(
                cap, model.embed_dim,
                budget_mb=float(c.get("host_budget_mb", 1024) or 1024),
                axis="distillation teacher feature cache",
                patch_tokens=self.patch_grid ** 2)
        self.requests = 0
        self.teacher_forwards = 0

    def serves(self, teacher_params: dict) -> bool:
        """Whether this server's serving model is ``teacher_params`` cast
        to the serving dtype, bit for bit (compared where the model lies)."""
        from dinov3_tpu_torch.serve.weights import cast_to

        mine = self.engine.model.state_dict()
        return mine.keys() == teacher_params.keys() and all(
            torch.equal(cast_to(teacher_params[k], v.dtype, v.device), v)
            for k, v in mine.items())

    def features_for_batch(self, global_crops):
        """(cls [2B, D_t] fp32, patches [2B, T, D_t] fp32) of one batch's
        global crops: hits replayed, misses packed through the engine."""
        imgs = np.asarray(global_crops, np.float32)
        n = imgs.shape[0]
        d = self.engine.model.embed_dim
        cls = np.zeros((n, d), np.float32)
        patches = np.zeros((n, self.patch_grid ** 2, d), np.float32)
        self.requests += n
        by_key: dict = {}
        for i in range(n):
            key = self.cache.key(imgs[i], self.fingerprint)
            val = self.cache.get(key)
            if val is not None:
                cls[i], patches[i] = val[0], val[3]
            else:
                by_key.setdefault(key, []).append(i)
        keys = list(by_key)
        for rid, key in enumerate(keys):
            self.engine.submit(imgs[by_key[key][0]], request_id=rid)
        while self.engine.queue_len:
            for resp in self.engine.flush():
                key = keys[resp.request_id]
                self.cache.put(key, (resp.cls_feature, resp.pooled_patch_feature,
                                     resp.n_patches, resp.patch_tokens))
                for i in by_key[key]:
                    cls[i] = resp.cls_feature
                    patches[i] = resp.patch_tokens
        self.teacher_forwards += len(keys)
        return cls, patches

    def annotate(self, batch: dict) -> dict:
        """The batch plus its ``teacher_cls`` / ``teacher_patches`` planes,
        what ``SSLMetaArch.get_teacher_output``'s serve arm reads."""
        cls, patches = self.features_for_batch(batch["global_crops"])
        return {**batch, "teacher_cls": cls, "teacher_patches": patches}

    def stats(self) -> dict:
        """Forward dedup, the cache's counters and the engine's step builds
        (``compile_count``, one)."""
        n = self.requests
        return {
            "requests": n,
            "teacher_forwards": self.teacher_forwards,
            "forwards_per_request": round(self.teacher_forwards / n, 4) if n else None,
            "compile_count": self.engine.compile_count,
            "weights_fingerprint": self.fingerprint,
            "cache": self.cache.stats(),
        }
