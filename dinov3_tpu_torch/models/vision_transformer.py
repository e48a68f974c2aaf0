"""DINOv3 Vision Transformer (``dinov3_tpu/models/vision_transformer.py``).

Patch embed -> [CLS + storage tokens + patches] -> RoPE-attention blocks
-> final norms. Ported: the forward over same-resolution images with the
iBOT mask token (``forward``: the teacher's and the serve path's), the eval-time
features of chosen blocks (``get_intermediate_layers``), the
crop-packed training forward of global and local crops in one block stack
(``forward(..., local_crops=...)``, with the step's drop-path plan and RoPE
coordinate augmentation), the two-pass training forward (``forward`` of
one crop kind at a time, ``crop_kind``), and
the serve forward over host-packed multi-image planes
(``packed_feature_forward``). Parameters carry the names of Meta's
``state_dict`` (``blocks.N.attn.qkv.weight``, ``patch_embed.proj.weight``,
...), so released weights load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from dinov3_tpu_torch.ops.block import REMAT_MODES, SelfAttentionBlock, remat_forward
from dinov3_tpu_torch.ops.common import canonical_dtype, trunc_normal_init
from dinov3_tpu_torch.ops.layer_scale import LayerScale
from dinov3_tpu_torch.ops.norms import LayerNorm, RMSNorm, make_norm_layer
from dinov3_tpu_torch.ops.packing import (
    make_packed_layout,
    pack_local_rows,
    packed_segment_ids,
    split_packed_output,
)
from dinov3_tpu_torch.ops.patch_embed import PatchEmbed
from dinov3_tpu_torch.ops.rope import (
    rope_angles_sincos,
    rope_packed_rows,
    rope_periods,
    rope_sincos,
    rope_with_identity_prefix,
)
from dinov3_tpu_torch.rng.plan import plan_layer_slice


class DinoVisionTransformer(nn.Module):
    def __init__(
        self,
        *,
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 768,
        n_blocks: int = 12,
        num_heads: int = 12,
        ffn_ratio: float = 4.0,
        qkv_bias: bool = True,
        proj_bias: bool = True,
        ffn_bias: bool = True,
        layerscale_init: float | None = None,
        drop_path_rate: float = 0.0,
        drop_path_mode: str = "subset",
        norm_layer: str = "layernorm",
        ffn_layer: str = "mlp",
        n_storage_tokens: int = 0,
        mask_k_bias: bool = False,
        untie_cls_and_patch_norms: bool = False,
        untie_global_and_local_cls_norm: bool = False,
        pos_embed_type: str = "rope",
        pos_embed_rope_base: float | None = 100.0,
        pos_embed_rope_min_period: float | None = None,
        pos_embed_rope_max_period: float | None = None,
        pos_embed_rope_normalize_coords: str = "separate",
        pos_embed_rope_shift_coords: float | None = None,
        pos_embed_rope_jitter_coords: float | None = None,
        pos_embed_rope_rescale_coords: float | None = None,
        pos_embed_rope_dtype: str = "fp32",
        remat: str = "none",
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}; expected none|attn|blocks|full")
        self.remat = remat
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = embed_dim
        self.n_blocks = n_blocks
        self.num_heads = num_heads
        self.n_storage_tokens = n_storage_tokens
        self.drop_path_rate = drop_path_rate
        self.drop_path_mode = drop_path_mode
        self.untie_cls_and_patch_norms = untie_cls_and_patch_norms
        self.untie_global_and_local_cls_norm = untie_global_and_local_cls_norm
        self.pos_embed_type = pos_embed_type
        self.rope_base = pos_embed_rope_base
        self.rope_min_period = pos_embed_rope_min_period
        self.rope_max_period = pos_embed_rope_max_period
        self.rope_normalize = pos_embed_rope_normalize_coords
        # training-time coordinate augmentation (None: off), drawn by the
        # step's plan (rng/plan.py)
        self.rope_shift = pos_embed_rope_shift_coords
        self.rope_jitter = pos_embed_rope_jitter_coords
        self.rope_rescale = pos_embed_rope_rescale_coords
        self.rope_dtype = canonical_dtype(pos_embed_rope_dtype)
        self.dtype = dtype

        self.patch_embed = PatchEmbed(embed_dim, patch_size, in_chans, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.storage_tokens = (
            nn.Parameter(torch.zeros(1, n_storage_tokens, embed_dim))
            if n_storage_tokens > 0 else None)
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.blocks = nn.ModuleList(
            SelfAttentionBlock(
                embed_dim, num_heads, ffn_ratio=ffn_ratio, ffn_layer=ffn_layer,
                norm_layer=norm_layer, qkv_bias=qkv_bias, proj_bias=proj_bias,
                ffn_bias=ffn_bias, layerscale_init=layerscale_init,
                mask_k_bias=mask_k_bias, drop_path_rate=drop_path_rate,
                dtype=dtype)
            for _ in range(n_blocks))
        self.norm = make_norm_layer(norm_layer, embed_dim)
        if untie_cls_and_patch_norms:
            self.cls_norm = make_norm_layer(norm_layer, embed_dim)
        if untie_global_and_local_cls_norm:
            # training-time local-crop CLS norm (the deterministic forwards
            # never read it)
            self.local_cls_norm = make_norm_layer(norm_layer, embed_dim)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def n_prefix(self) -> int:
        return 1 + self.n_storage_tokens

    @property
    def rope_aug(self) -> tuple | None:
        """(shift, jitter, rescale) when a training forward augments the
        RoPE coordinates, else None."""
        aug = (self.rope_shift, self.rope_jitter, self.rope_rescale)
        if self.pos_embed_type != "rope" or all(a is None for a in aug):
            return None
        return aug

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init: truncated-normal(0.02) matmul weights, zero
        biases, unit norms, LayerScale at its init value, normal(0.02)
        CLS and storage tokens, a zero mask token. Draws in parameter
        order from ``generator``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    trunc_normal_init(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (LayerNorm, RMSNorm)):
                    m.weight.fill_(1.0)
                    if isinstance(m, LayerNorm):
                        m.bias.zero_()
                elif isinstance(m, LayerScale):
                    m.gamma.fill_(m.init_value)
            trunc_normal_init(self.patch_embed.proj.weight, generator)
            self.patch_embed.proj.bias.zero_()
            self.cls_token.normal_(0.0, 0.02, generator=generator)
            if self.storage_tokens is not None:
                self.storage_tokens.normal_(0.0, 0.02, generator=generator)
            self.mask_token.zero_()

    # ---------------- pieces ----------------

    def _prefix_table(self, dtype) -> torch.Tensor:
        """[1 + S, D]: the CLS token, then the storage tokens."""
        table = self.cls_token[0]
        if self.storage_tokens is not None:
            table = torch.cat([table, self.storage_tokens[0]], dim=0)
        return table.to(dtype)

    def _periods(self, device) -> torch.Tensor:
        return rope_periods(self.head_dim, base=self.rope_base,
                            min_period=self.rope_min_period,
                            max_period=self.rope_max_period, device=device)

    def _rope_table(self, h: int, w: int, device, aug: dict | None = None):
        """The [1 + S + h*w, head_dim] (sin, cos) table; ``aug``: a training
        forward's augmentation factors."""
        if self.pos_embed_type != "rope":
            return None
        sin, cos = rope_sincos(h, w, self._periods(device),
                               normalize=self.rope_normalize,
                               dtype=self.rope_dtype, aug=aug)
        return rope_with_identity_prefix(sin, cos, self.n_prefix)

    def _serve_rope(self, coords: torch.Tensor):
        """Per-token (sin, cos) [R, N, head_dim] from the host coordinate
        plane; zero coordinates give the identity rotation of prefix and
        pad slots."""
        if self.pos_embed_type != "rope":
            return None
        return rope_angles_sincos(coords, self._periods(coords.device),
                                  dtype=self.rope_dtype)

    def _embed(self, x, masks=None):
        """[B, H, W, C] -> ([B, 1+S+T, D], (h, w)); masked patch tokens
        (masks [B, T] bool) become the mask token."""
        B = x.shape[0]
        h, w = x.shape[1] // self.patch_size, x.shape[2] // self.patch_size
        tokens = self.patch_embed(x)
        if masks is not None:
            tokens = torch.where(masks[..., None],
                                 self.mask_token.to(tokens.dtype), tokens)
        prefix = self._prefix_table(tokens.dtype)
        return torch.cat([prefix[None].expand(B, -1, -1), tokens], dim=1), (h, w)

    def _run_blocks(self, x, rope, seg=None, plan=None, train=False,
                    collect: dict | None = None):
        """The block stack; a training call that builds a graph runs each
        block under ``self.remat``'s activation checkpointing. ``collect``:
        a dict keyed by block indices, each filled with that block's
        output."""
        remat = self.remat if train and torch.is_grad_enabled() else "none"
        for i, blk in enumerate(self.blocks):
            x = remat_forward(blk, remat)(x, rope=rope, seg=seg,
                                          plan=plan_layer_slice(plan, i))
            if collect is not None and i in collect:
                collect[i] = x
        return x

    def _check_plan(self, train: bool, plan) -> dict | None:
        """The plan a call consumes: none when deterministic; a training
        call with drop path must bring its drop-path plan, and one with
        RoPE augmentation its factors."""
        if not train:
            return None
        if self.drop_path_rate > 0.0 and not (plan or {}).get("drop_path"):
            raise ValueError(
                "a training forward with drop_path_rate > 0 needs the step's "
                "drop-path plan (rng/plan.py)")
        if self.rope_aug is not None and "rope" not in (plan or {}):
            raise ValueError(
                "a training forward with RoPE coordinate augmentation needs "
                "the step's augmentation factors (rng/plan.py)")
        return plan

    def _final_norms(self, x, *, crop_kind: str, train: bool):
        """(normed prefix tokens, normed patch tokens) of a block output."""
        n = self.n_prefix
        if not (self.untie_cls_and_patch_norms
                or self.untie_global_and_local_cls_norm):
            xn = self.norm(x)
            return xn[:, :n], xn[:, n:]
        return self._cls_norm(crop_kind, train)(x[:, :n]), self.norm(x[:, n:])

    def _cls_norm(self, crop_kind: str, train: bool):
        if self.untie_global_and_local_cls_norm and train and crop_kind == "local":
            return self.local_cls_norm
        return self.cls_norm if self.untie_cls_and_patch_norms else self.norm

    # ---------------- forwards ----------------

    def forward(self, x: torch.Tensor, masks: torch.Tensor | None = None, *,
                train: bool = False, plan: dict | None = None,
                local_crops: torch.Tensor | None = None,
                crop_kind: str = "global") -> dict:
        """Forward of same-resolution images x [B, H, W, C]; masks
        optional [B, T] bool (those patch tokens become the mask token).

        Returns x_norm_clstoken [B, D], x_storage_tokens [B, S, D],
        x_norm_patchtokens [B, T, D], x_prenorm [B, 1+S+T, D] and masks.
        ``train`` with ``plan`` (the pass's plan: {"drop_path": ...,
        "rope": augmentation factors}) is the student's forward of one crop
        kind (``crop_kind``: "local" picks the local-CLS norm where it is
        untied); with ``local_crops`` [n_l*B, h, w, C] the local crops are
        packed k to a global-length row and run through the same block
        stack (``_packed_forward``, ``plan["rope"]`` then holds "global"
        and "local" factors), and the dict also carries ``local_cls``
        [n_l*B, D] and ``local_storage_tokens``."""
        plan = self._check_plan(train, plan)
        if local_crops is not None:
            return self._packed_forward(x, masks, local_crops, plan, train)
        tokens, (h, w) = self._embed(x, masks)
        rope = self._rope_table(h, w, x.device, aug=(plan or {}).get("rope"))
        out = self._run_blocks(tokens, rope, plan=plan, train=train)
        x_cls_reg, x_patch = self._final_norms(out, crop_kind=crop_kind,
                                               train=train)
        return {
            "x_norm_clstoken": x_cls_reg[:, 0],
            "x_storage_tokens": x_cls_reg[:, 1:],
            "x_norm_patchtokens": x_patch,
            "x_prenorm": out,
            "masks": masks,
        }

    def _packed_forward(self, x, masks, local_crops, plan, train) -> dict:
        """Global and local crops in one block stack: 2B global rows plus
        P = ceil(n_l*B / k) rows of k local sequences each, under
        segment-masked attention and per-row RoPE tables
        (``ops/packing.py``). Norms are per token, so norming the local
        prefix tokens after extraction equals norming before."""
        g_tokens, (hg, wg) = self._embed(x, masks)
        l_tokens, (hl, wl) = self._embed(local_crops)
        layout = make_packed_layout(
            n_global_rows=g_tokens.shape[0], n_local=l_tokens.shape[0],
            seq_global=g_tokens.shape[1], seq_local=l_tokens.shape[1],
            n_prefix=self.n_prefix)
        if layout.k < 2:
            raise ValueError(
                f"crop packing needs k >= 2 local sequences per global row "
                f"(N_g={layout.seq_global}, N_l={layout.seq_local})")
        with torch.profiler.record_function("crop_pack"):
            tokens = torch.cat([g_tokens, pack_local_rows(l_tokens, layout)])
        seg = torch.from_numpy(packed_segment_ids(layout)).to(x.device, non_blocking=True)
        rope = None
        if self.pos_embed_type == "rope":
            # each crop kind's table takes its own factors, those the
            # two-pass forward takes
            aug = (plan or {}).get("rope") or {}
            rope = rope_packed_rows(
                self._rope_table(hg, wg, x.device, aug=aug.get("global")),
                self._rope_table(hl, wl, x.device, aug=aug.get("local")), layout)
        out = self._run_blocks(tokens, rope, seg=seg, plan=plan, train=train)
        g_rows, p_rows = split_packed_output(out, layout)
        l_tok = p_rows[:, : layout.k * layout.seq_local]
        l_prefix = l_tok.reshape(layout.n_packed_rows * layout.k,
                                 layout.seq_local, -1)[: layout.n_local,
                                                       : self.n_prefix]
        x_cls_reg, x_patch = self._final_norms(g_rows, crop_kind="global",
                                               train=train)
        l_cls_reg = self._cls_norm("local", train)(l_prefix)
        return {
            "x_norm_clstoken": x_cls_reg[:, 0],
            "x_storage_tokens": x_cls_reg[:, 1:],
            "x_norm_patchtokens": x_patch,
            "x_prenorm": out,
            "masks": masks,
            "local_cls": l_cls_reg[:, 0],
            "local_storage_tokens": l_cls_reg[:, 1:],
        }

    def packed_feature_forward(self, patches, coords, prefix_idx, seg) -> dict:
        """Serve forward over host-packed planes (``serve/batcher.py``).

        patches [R, N, p, p, C] pixels (zeros at prefix and pad slots);
        coords [R, N, 2] fp32 patch coordinates (zeros at prefix and pad
        slots); prefix_idx [R, N] int (0 = CLS, s = storage token s-1,
        -1 = patch or pad); seg [R, N] int32 segment ids (-1 = pad, pads
        attend only among themselves).

        Returns {"cls_rows", "patch_rows"} [R, N, D]: the block output
        normed with the CLS norm and with the patch norm. With tied norms
        both are the same norm, applied twice, as in the reference."""
        R, N = seg.shape
        tok = self.patch_embed.embed_patches(patches)
        # zero the pad slots (a zero patch embeds to the bias) and inject
        # the prefix tokens
        is_prefix = (prefix_idx >= 0)[..., None]
        keep = (seg >= 0)[..., None] & ~is_prefix
        tok = torch.where(keep, tok, tok.new_zeros(()))
        table = self._prefix_table(tok.dtype)
        pre = table[prefix_idx.clamp(0, table.shape[0] - 1).long()]
        tok = torch.where(is_prefix, pre, tok)
        out = self._run_blocks(tok, self._serve_rope(coords), seg=seg)
        cls_norm = self.cls_norm if self.untie_cls_and_patch_norms else self.norm
        return {"cls_rows": cls_norm(out), "patch_rows": self.norm(out)}

    def get_intermediate_layers(self, x: torch.Tensor, n=1, *,
                                reshape: bool = False,
                                return_class_token: bool = False,
                                return_extra_tokens: bool = False,
                                norm: bool = True) -> tuple:
        """Eval-time features of chosen blocks, for images x [B, H, W, C].

        ``n``: an int takes the last n blocks, a sequence the blocks at
        those indices (out-of-range indices raise ``ValueError``). With
        ``norm`` each output is normed as the final norms do: ``norm``,
        or ``cls_norm`` on the prefix tokens and ``norm`` on the patches
        under ``untie_cls_and_patch_norms``. Returns a tuple, one entry a
        block: the patch tokens [B, T, D] (``reshape``: [B, D, h, w]),
        paired with the CLS token [B, D] and/or the storage tokens
        [B, S, D] when asked for."""
        take = (list(range(self.n_blocks - n, self.n_blocks))
                if isinstance(n, int) else list(n))
        bad = [i for i in take if not 0 <= i < self.n_blocks]
        if bad:
            raise ValueError(
                f"layer indices {bad} out of range for {self.n_blocks} blocks")
        tokens, (h, w) = self._embed(x)
        collected = dict.fromkeys(take)
        self._run_blocks(tokens, self._rope_table(h, w, x.device),
                         collect=collected)
        outputs = [collected[i] for i in take]
        k = self.n_prefix
        if norm:
            if self.untie_cls_and_patch_norms:
                outputs = [torch.cat([self.cls_norm(o[:, :k]), self.norm(o[:, k:])],
                                     dim=1) for o in outputs]
            else:
                outputs = [self.norm(o) for o in outputs]
        class_tokens = [o[:, 0] for o in outputs]
        extra = [o[:, 1:k] for o in outputs]
        patches = [o[:, k:] for o in outputs]
        if reshape:
            B = x.shape[0]
            patches = [p.reshape(B, h, w, -1).permute(0, 3, 1, 2) for p in patches]
        if return_class_token and return_extra_tokens:
            return tuple(zip(patches, class_tokens, extra))
        if return_class_token:
            return tuple(zip(patches, class_tokens))
        if return_extra_tokens:
            return tuple(zip(patches, extra))
        return tuple(patches)


# ---------------- size ladder ----------------

def _ctor(embed_dim, n_blocks, num_heads, ffn_ratio):
    def build(patch_size: int = 16, **kwargs) -> DinoVisionTransformer:
        if kwargs.get("ffn_ratio") is None:  # None defers to the ladder ratio
            kwargs.pop("ffn_ratio", None)
        args = dict(patch_size=patch_size, embed_dim=embed_dim,
                    n_blocks=n_blocks, num_heads=num_heads, ffn_ratio=ffn_ratio)
        args.update(kwargs)
        return DinoVisionTransformer(**args)

    return build


vit_small = _ctor(384, 12, 6, 4.0)
vit_base = _ctor(768, 12, 12, 4.0)
vit_large = _ctor(1024, 24, 16, 4.0)
vit_so400m = _ctor(1152, 27, 18, 3.777777778)
vit_huge2 = _ctor(1280, 32, 20, 4.0)
vit_giant2 = _ctor(1536, 40, 24, 4.0)
vit_7b = _ctor(4096, 40, 32, 3.0)
# tiny configs for tests (not in the reference ladder)
vit_test = _ctor(64, 2, 2, 2.0)
vit_test_big = _ctor(96, 3, 2, 2.0)
vit_test4 = _ctor(64, 4, 2, 2.0)
vit_test_wide = _ctor(128, 4, 4, 2.0)
vit_test40 = _ctor(64, 40, 2, 3.0)

ARCHS = {
    "vit_small": vit_small, "vit_base": vit_base, "vit_large": vit_large,
    "vit_so400m": vit_so400m, "vit_huge2": vit_huge2,
    "vit_giant2": vit_giant2, "vit_7b": vit_7b, "vit_test": vit_test,
    "vit_test_big": vit_test_big, "vit_test4": vit_test4,
    "vit_test_wide": vit_test_wide, "vit_test40": vit_test40,
}
