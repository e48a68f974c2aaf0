"""DINOv3 SSL meta-architecture on one device
(``dinov3_tpu/train/ssl_meta_arch.py``: the crop-packed student, or the
two-pass student under ``model.crop_packing=false``; teacher
targets by Sinkhorn-Knopp or softmax centering, streamed K-tile by K-tile
(``loss.streaming_targets``, the default) or materialized, DINO + iBOT +
KoLeo losses).

``SSLMetaArch`` is an ``nn.Module`` holding the student and the EMA
teacher, each an ``nn.ModuleDict`` of ``backbone`` (the ViT),
``dino_head`` and ``ibot_head``; the teacher starts as a copy of the
student and gets no gradients. Parameters are fp32 masters; the backbones
and the heads' MLPs compute in ``compute_precision.compute_dtype``.

Batch contract (``data/synthetic.py``): global_crops [2B, S, S, 3],
local_crops [n_l*B, s, s, 3], masks [2B, T] bool, mask_indices [2B, M]
int (per-image token index, 0-padded), mask_weights [2B, M] fp32
(1/n_masked of the image, 0 for padding), mask_valid [2B, M] bool.

The student's randomness comes from the step's plan (``rng/plan.py``):
``draw_plan`` makes it, by the step plan or, under ``rng.plan=false``,
by per-pass and per-block generators; tests hand the JAX plan in instead.
"""

from __future__ import annotations

import copy
import logging

import torch
from torch import nn

from dinov3_tpu_torch.configs.config import (
    check_train_slice,
    crop_packing_wished,
    rng_plan_wished,
    streaming_targets_wished,
)
from dinov3_tpu_torch.logging_utils import LOGGER_NAME
from dinov3_tpu_torch.losses import (
    ibot_loss_from_spec,
    koleo_loss,
    pair_ce_from_spec,
    pair_ce_to_loss,
    sinkhorn_knopp,
    softmax_center_teacher,
    update_center,
)
from dinov3_tpu_torch.models import ARCHS, backbone_kwargs_from_cfg, fp8_blocks
from dinov3_tpu_torch.ops.common import Policy, canonical_dtype
from dinov3_tpu_torch.ops.dino_head import DINOHead
from dinov3_tpu_torch.ops.packing import packed_layout
from dinov3_tpu_torch.rng.plan import fold_in_plan, step_generator, step_plan
from dinov3_tpu_torch.train.optimizer import ema_

logger = logging.getLogger(LOGGER_NAME)


def _head(cfg_section, in_dim: int, dtype) -> DINOHead:
    return DINOHead(
        in_dim, cfg_section.head_n_prototypes,
        hidden_dim=cfg_section.head_hidden_dim,
        bottleneck_dim=cfg_section.head_bottleneck_dim,
        nlayers=cfg_section.head_nlayers,
        norm_last_layer=cfg_section.head_norm_last_layer, dtype=dtype)


class SSLMetaArch(nn.Module):
    def __init__(self, cfg, seed: int = 0, n_blocks: int | None = None):
        """``n_blocks`` cuts the configured depth (card-vs-CPU checks at
        full width); None keeps it (``student.n_blocks``, else the
        arch's)."""
        super().__init__()
        check_train_slice(cfg)
        arch = cfg.student.arch
        if arch not in ARCHS:
            raise NotImplementedError(
                f"student.arch={arch!r}: the training slice ports the ViTs "
                f"{sorted(ARCHS)}")
        self.cfg = cfg
        self.n_local_crops = cfg.crops.local_crops_number
        self.centering = cfg.train.centering
        if self.centering not in ("sinkhorn_knopp", "softmax_center"):
            raise ValueError(f"unknown centering {self.centering!r}")
        # the [*, K] target storage (None: fp32); reductions stay fp32
        self.target_dtype = canonical_dtype(
            cfg.compute_precision.get("target_dtype") or None)
        # streaming K-tiled CE (losses/streaming.py) or materialized targets
        self.streaming_targets = streaming_targets_wished(cfg)
        self.loss_k_tile = int((cfg.get("loss") or {}).get("k_tile") or 8192)
        # the crop-packed student (default) or the two-pass oracle; a batch
        # whose local crops do not pack two to a row runs the two passes
        self.crop_packing = crop_packing_wished(cfg)
        # the step plan (default) or the per-pass, per-block generators
        self.rng_plan = rng_plan_wished(cfg)
        self._warned_unpacked = False
        dtype = Policy.from_cfg(cfg.compute_precision).compute_dtype
        depth = {} if n_blocks is None else {"n_blocks": n_blocks}
        backbone = ARCHS[arch](**{**backbone_kwargs_from_cfg(cfg, teacher=False), **depth})
        if fp8_blocks(cfg):  # the student's block products only
            for blk in backbone.blocks:
                blk.attn.fp8 = blk.mlp.fp8 = True
        self.embed_dim = backbone.embed_dim
        self.student = nn.ModuleDict({
            "backbone": backbone,
            "dino_head": _head(cfg.dino, self.embed_dim, dtype),
            "ibot_head": _head(cfg.ibot, self.embed_dim, dtype),
        })
        g = torch.Generator().manual_seed(seed)
        backbone.init_weights(g)
        self.student["dino_head"].init_weights(g)
        self.student["ibot_head"].init_weights(g)
        self.student.float()
        teacher_backbone = ARCHS[arch](**{**backbone_kwargs_from_cfg(cfg, teacher=True),
                                          **depth})
        self.teacher = nn.ModuleDict({
            "backbone": teacher_backbone,
            "dino_head": copy.deepcopy(self.student["dino_head"]),
            "ibot_head": copy.deepcopy(self.student["ibot_head"]),
        }).float()
        self.teacher.load_state_dict(self.student.state_dict())
        self.teacher.requires_grad_(False)
        self.dino_local_weight_schedule = None
        if cfg.dino.reweight_dino_local_loss:
            from dinov3_tpu_torch.train.schedules import linear_warmup_cosine_decay

            s = cfg.dino.local_loss_weight_schedule
            L = cfg.train.OFFICIAL_EPOCH_LENGTH
            self.dino_local_weight_schedule = linear_warmup_cosine_decay(
                start=s["start"], peak=s["peak"], end=s["end"],
                warmup_iterations=int(s.get("warmup_epochs", 0) * L),
                total_iterations=L * cfg.optim.epochs)

    # ---------------- forwards ----------------

    @staticmethod
    def _gather_masked(patch_tokens, mask_indices):
        """[2B, T, D], [2B, M] -> [2B, M, D]."""
        idx = mask_indices.long()[..., None].expand(-1, -1, patch_tokens.shape[-1])
        return torch.gather(patch_tokens, 1, idx)

    def init_state(self, device=None) -> dict:
        """The softmax-centering EMA centers, fp32 zeros (kept, unused,
        under Sinkhorn-Knopp, as in the reference)."""
        kw = dict(dtype=torch.float32, device=device)
        return {"dino_center": torch.zeros(1, self.cfg.dino.head_n_prototypes, **kw),
                "ibot_center": torch.zeros(1, self.cfg.ibot.head_n_prototypes, **kw)}

    @torch.no_grad()
    def get_teacher_output(self, batch: dict, teacher_temp: float, state: dict):
        """The EMA teacher over the global crops, then its targets:
        (targets, new center state)."""
        out = self.teacher["backbone"](batch["global_crops"])
        return self.teacher_targets_from_features(
            out["x_norm_clstoken"], out["x_norm_patchtokens"], batch,
            teacher_temp, state)

    @torch.no_grad()
    def teacher_targets_from_features(self, cls, patches, batch: dict,
                                      teacher_temp: float, state: dict):
        """Heads -> centering -> target specs, from cls [2B, D] and patches
        [2B, T, D]. Returns ({"cls_target", "masked_target", ...}, new
        state). Specs (``losses/streaming.py``): {"kind": "probs"} holds
        materialized [2, B, K] / [2B*M, K'] targets (zero rows at padding);
        {"kind": "sinkhorn"} the Sinkhorn factors; {"kind":
        "softmax_center"} the raw logits, the incoming center and the
        temperature. The centers' EMA reads the raw logits on both paths."""
        n_g = 2
        B = cls.shape[0] // n_g
        cls_logits = self.teacher["dino_head"](cls)                       # [2B, K]
        masked = self._gather_masked(patches, batch["mask_indices"])
        masked_logits = self.teacher["ibot_head"](masked.reshape(-1, cls.shape[-1]))
        valid = batch["mask_valid"].reshape(-1)
        new_state = dict(state)
        tgt, stream = self.target_dtype, self.streaming_targets
        if self.centering == "sinkhorn_knopp":
            cls_t = sinkhorn_knopp(cls_logits, teacher_temp, storage_dtype=tgt,
                                   return_factors=stream)
            masked_t = sinkhorn_knopp(masked_logits, teacher_temp,
                                      row_weights=valid.float(), storage_dtype=tgt,
                                      return_factors=stream)
            if stream:
                cls_target = {"kind": "sinkhorn", "factors": cls_t}
                masked_target = {"kind": "sinkhorn", "factors": masked_t}
            else:
                cls_target = {"kind": "probs", "probs": cls_t.reshape(n_g, B, -1)}
                masked_target = {"kind": "probs", "probs": masked_t}
        else:
            if stream:
                # padding rows are weighted out by mask_weights in the loss
                cls_target = {"kind": "softmax_center",
                              "logits": cls_logits.reshape(n_g, B, -1),
                              "center": state["dino_center"], "temp": teacher_temp}
                masked_target = {"kind": "softmax_center", "logits": masked_logits,
                                 "center": state["ibot_center"], "temp": teacher_temp}
            else:
                cls_p = softmax_center_teacher(cls_logits, state["dino_center"],
                                               teacher_temp, storage_dtype=tgt)
                masked_p = softmax_center_teacher(
                    masked_logits, state["ibot_center"], teacher_temp,
                    storage_dtype=tgt) * valid[:, None].to(tgt or masked_logits.dtype)
                cls_target = {"kind": "probs", "probs": cls_p.reshape(n_g, B, -1)}
                masked_target = {"kind": "probs", "probs": masked_p}
            new_state["dino_center"] = update_center(state["dino_center"], cls_logits)
            w = valid.float()[:, None]
            masked_mean = (masked_logits * w).sum(dim=0, keepdim=True)
            masked_mean = masked_mean / w.sum().clamp(min=1.0)
            new_state["ibot_center"] = state["ibot_center"] * 0.9 + masked_mean * 0.1
        return {
            "cls_pre_head": cls.reshape(n_g, B, -1),
            "patch_pre_head": patches,
            "cls_target": cls_target,
            "masked_target": masked_target,
        }, new_state

    def packs(self, batch: dict) -> bool:
        """Whether this batch's student runs crop-packed: asked for, and at
        least two local sequences fit a global row (else the two passes,
        with a warning, as the reference falls back)."""
        if not self.crop_packing:
            return False
        if packed_layout(self.cfg, batch).k >= 2:
            return True
        if not self._warned_unpacked:
            logger.warning("model.crop_packing: local sequences do not pack two "
                           "to a global row; the student runs two passes")
            self._warned_unpacked = True
        return False

    def plan_rows(self, batch: dict) -> dict:
        """The rows each student pass draws its drop path over:
        {"packed": 2B + P}, or {"global": 2B, "local": n_l*B}."""
        if self.packs(batch):
            return {"packed": packed_layout(self.cfg, batch).rows_total}
        return {"global": batch["global_crops"].shape[0],
                "local": batch["local_crops"].shape[0]}

    def draw_plan(self, seed: int, iteration: int, batch: dict,
                  microbatch: int | None = None) -> dict:
        """The student's plan for this batch at ``iteration``: the step
        plan from ``step_generator`` or, under ``rng.plan=false``, the
        per-pass, per-block generators of ``fold_in_plan``."""
        bb = self.student["backbone"]
        kw = dict(n_blocks=bb.n_blocks, rows=self.plan_rows(batch),
                  rate=bb.drop_path_rate, mode=bb.drop_path_mode,
                  rope_aug=bb.rope_aug)
        if self.rng_plan:
            return step_plan(step_generator(seed, iteration, microbatch), **kw)
        return fold_in_plan(seed, iteration, microbatch, **kw)

    def get_student_output(self, batch: dict, plan: dict | None):
        """The student backbone over global and local crops, crop-packed in
        one pass or in two (``packs``), then the heads: (global_out,
        local_out) dicts as the reference's. ``plan``: the packed pass's
        plan, or {"global": plan, "local": plan} for the two passes; a
        JAX step plan ({"global", "local", "packed"}) serves either."""
        g, l = batch["global_crops"], batch["local_crops"]
        n_g, n_l = 2, self.n_local_crops
        B = g.shape[0] // n_g
        plan = plan or {}
        bb = self.student["backbone"]
        if self.packs(batch):
            out = bb(g, batch["masks"], train=True, plan=plan.get("packed", plan),
                     local_crops=l)
            g_cls, g_patch = out["x_norm_clstoken"], out["x_norm_patchtokens"]
            l_cls = out["local_cls"]
        else:
            g_out = bb(g, batch["masks"], train=True, plan=plan.get("global"))
            l_out = bb(l, None, train=True, plan=plan.get("local"), crop_kind="local")
            g_cls, g_patch = g_out["x_norm_clstoken"], g_out["x_norm_patchtokens"]
            l_cls = l_out["x_norm_clstoken"]
        masked = self._gather_masked(g_patch, batch["mask_indices"])
        M = masked.shape[1]
        masked_logits = self.student["ibot_head"](masked.reshape(-1, self.embed_dim))
        # one DINO-head call for global and local CLS
        cls_logits = self.student["dino_head"](torch.cat([g_cls, l_cls]))
        K = cls_logits.shape[-1]
        global_out = {
            "cls_pre_head": g_cls.reshape(n_g, B, -1),
            "patch_pre_head": g_patch,
            "cls_after_head": cls_logits[: n_g * B].reshape(n_g, B, K),
            "masked_patch_after_head": masked_logits.reshape(2 * B, M, -1),
        }
        local_out = {
            "cls_pre_head": l_cls.reshape(n_l, B, -1),
            "cls_after_head": cls_logits[n_g * B:].reshape(n_l, B, K),
        }
        return global_out, local_out

    # ---------------- loss ----------------

    def compute_losses(self, teacher_global, student_global, student_local,
                       batch: dict, iteration: int = 0):
        cfg = self.cfg
        n_g, n_l = 2, self.n_local_crops
        ignore_diag = bool(cfg.dino.global_ignore_diagonal)
        g_terms = n_g * (n_g - 1) if ignore_diag else n_g * n_g
        l_terms = n_g * n_l
        g_scale = g_terms / (g_terms + l_terms)
        l_scale = l_terms / (g_terms + l_terms)
        local_w = 1.0
        if self.dino_local_weight_schedule is not None:
            sched = self.dino_local_weight_schedule
            local_w = float(sched[min(iteration, len(sched) - 1)])
        loss_dict = {}
        g_rows = student_global["cls_after_head"]
        B = g_rows.shape[1]
        # one pair-CE over every student crop against the teacher targets
        pair = pair_ce_from_spec(torch.cat([g_rows, student_local["cls_after_head"]]),
                                 teacher_global["cls_target"], k_tile=self.loss_k_tile)
        dino_local = pair_ce_to_loss(pair[n_g:], B)
        dino_global = pair_ce_to_loss(pair[:n_g], B, ignore_diagonal=ignore_diag)
        loss_dict["dino_local_crops_loss"] = dino_local
        loss_dict["dino_global_crops_loss"] = dino_global
        total = cfg.dino.loss_weight * l_scale * local_w * dino_local
        total = total + cfg.dino.loss_weight * g_scale * dino_global
        distributed = cfg.dino.koleo_loss_distributed
        group = cfg.dino.koleo_distributed_loss_group_size if distributed else None
        topk = cfg.dino.koleo_topk if distributed else 1
        kol = sum(koleo_loss(c, topk=topk, group_size=group)
                  for c in student_global["cls_pre_head"]) / n_g
        loss_dict["koleo_loss"] = kol
        total = total + cfg.dino.koleo_loss_weight * n_g * kol
        ibot = ibot_loss_from_spec(
            student_global["masked_patch_after_head"].reshape(
                -1, cfg.ibot.head_n_prototypes),
            teacher_global["masked_target"],
            batch["mask_weights"].reshape(-1), n_images=batch["masks"].shape[0],
            k_tile=self.loss_k_tile)
        loss_dict["ibot_loss"] = ibot
        total = total + cfg.ibot.loss_weight * ibot
        loss_dict["total_loss"] = total
        return total, loss_dict

    def forward(self, batch: dict, *, teacher_temp: float, iteration: int = 0,
                plan: dict | None = None, state: dict | None = None):
        """(total loss, {loss name: scalar}, new center state) of one
        batch; gradients reach only the student. ``plan``: the student's
        plan (``get_student_output``); ``state``: the incoming centers
        (``init_state()`` when None)."""
        if state is None:
            state = self.init_state(batch["global_crops"].device)
        teacher_global, new_state = self.get_teacher_output(batch, teacher_temp, state)
        student_global, student_local = self.get_student_output(batch, plan)
        total, loss_dict = self.compute_losses(teacher_global, student_global,
                                               student_local, batch, iteration)
        return total, loss_dict, new_state

    @torch.no_grad()
    def update_ema(self, momentum: float) -> None:
        """teacher <- m * teacher + (1 - m) * student, in place."""
        ema_(list(self.teacher.parameters()), list(self.student.parameters()),
             momentum)
