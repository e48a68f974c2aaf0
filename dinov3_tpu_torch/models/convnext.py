"""ConvNeXt backbone (``dinov3_tpu/models/convnext.py``), channels-last.

The architecture table (tiny / small / base / large) and the DINO
adaptations of the JAX package: a mean-pooled pseudo-CLS token, one final
norm over [cls | patches], and a ``patch_size`` option that resizes the
stage-4 map bilinearly onto the ViT patch grid (``jax.image.resize``'s
weights, ``ops/resize.py``), so a ConvNeXt student shares the SSL
meta-arch, its heads and its teachers with the ViTs.

Modules keep the JAX package's names (``stem_conv``, ``stem_norm``,
``down{i}_norm``, ``down{i}_conv``, ``stage{i}_block{j}.dwconv / norm /
pwconv1 / pwconv2 / gamma``, ``norm``), so the weight bridge
(``interop/from_jax.py``) and the parameter-group rules read the same
names. No stage holds a ``blocks`` list: ConvNeXt takes no layer-wise lr
decay, as in the JAX package (``train/param_groups.py``).

Numerics follow the JAX modules: activations stay [B, H, W, C], so each
LayerNorm (``ops/norms.py``: kernels K4 / K5 on the card) reads contiguous
[rows, C] rows and each convolution runs on the NCHW view of that
channels-last memory; every conv and ``Dense`` casts its input, weight and
bias to the compute dtype; the convs pad as flax's ``"SAME"`` does (the
strided stem and downsample convs too: a 7-wide stage downsamples to 4,
the missing column padded after); the block's GELU is the tanh form
(flax ``nn.gelu``'s default, not the ViT FFN's exact one); ``gamma`` is
cast to the activations' dtype; the pseudo-CLS is the mean of the final
features in their dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dinov3_tpu_torch.ops.common import dense, trunc_normal_init
from dinov3_tpu_torch.ops.drop_path import DropPath
from dinov3_tpu_torch.ops.norms import LayerNorm
from dinov3_tpu_torch.ops.resize import resize_grid


def same_pads(n: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one axis of n samples under flax's
    ``"SAME"``: ceil(n / stride) outputs, the odd sample of padding
    after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` over x [B, H, W, C] with ``"SAME"`` padding, in ``dtype``:
    the conv runs on the NCHW view of the channels-last memory (no copy)
    and hands back the NHWC view of its channels-last output."""
    (k, _), (s, _) = conv.kernel_size, conv.stride
    ph, pw = same_pads(x.shape[1], k, s), same_pads(x.shape[2], k, s)
    x = x.to(dtype)
    padding = 0
    if s == 1 and ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    elif ph != (0, 0) or pw != (0, 0):
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    w = conv.weight.to(dtype=dtype, memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, conv.bias.to(dtype), stride=s,
                 padding=padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    """7 x 7 depthwise conv -> LayerNorm -> Dense 4C -> tanh GELU -> Dense C
    -> layer scale -> drop path, added to the input."""

    def __init__(self, dim: int, drop_path_rate: float = 0.0,
                 layer_scale_init: float | None = 1e-6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.dwconv = nn.Conv2d(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.layer_scale_init = layer_scale_init
        self.gamma = (nn.Parameter(torch.full((dim,), float(layer_scale_init)))
                      if layer_scale_init is not None else None)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, keep_bits: torch.Tensor | None = None) -> torch.Tensor:
        y = self.norm(conv_nhwc(x, self.dwconv, self.dtype))
        y = dense(y, self.pwconv1.weight, self.pwconv1.bias, self.dtype)
        y = F.gelu(y, approximate="tanh")
        y = dense(y, self.pwconv2.weight, self.pwconv2.bias, self.dtype)
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        return x + self.drop_path(y, keep_bits)


class ConvNeXt(nn.Module):
    """Four stages of ``ConvNeXtBlock`` behind a 4 x 4 stride-4 stem and
    three 2 x 2 stride-2 downsamples, with the ViT's output contract."""

    n_storage_tokens = 0
    remat = "none"  # the JAX ConvNeXt has no activation checkpointing

    def __init__(self, *, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate: float = 0.0,
                 layer_scale_init: float | None = 1e-6, in_chans: int = 3,
                 patch_size: int | None = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.drop_path_rate = float(drop_path_rate)
        self.in_chans = in_chans
        self.patch_size = patch_size
        self.dtype = dtype
        rates = self.dp_rates()
        self.stem_conv = nn.Conv2d(in_chans, dims[0], 4, stride=4)
        self.stem_norm = LayerNorm(dims[0])
        k = 0
        for i in range(4):
            if i > 0:
                setattr(self, f"down{i}_norm", LayerNorm(dims[i - 1]))
                setattr(self, f"down{i}_conv", nn.Conv2d(dims[i - 1], dims[i], 2, stride=2))
            for j in range(self.depths[i]):
                setattr(self, f"stage{i}_block{j}", ConvNeXtBlock(
                    dims[i], rates[k], layer_scale_init, dtype))
                k += 1
        self.norm = LayerNorm(dims[-1])

    @property
    def embed_dim(self) -> int:
        return self.dims[-1]

    @property
    def n_blocks(self) -> int:
        """Blocks over all stages: the rows of a pass's drop-path plan."""
        return sum(self.depths)

    def dp_rates(self) -> list[float]:
        """Stochastic depth rising linearly from 0 to ``drop_path_rate``
        over the blocks of all stages."""
        total = sum(self.depths)
        if total <= 1 or self.drop_path_rate == 0.0:
            return [0.0] * total
        return [self.drop_path_rate * k / (total - 1) for k in range(total)]

    def stage_blocks(self, i: int) -> list[ConvNeXtBlock]:
        return [getattr(self, f"stage{i}_block{j}") for j in range(self.depths[i])]

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init: truncated-normal(0.02) conv and ``Dense`` kernels,
        zero biases, unit norms, ``gamma`` at its init value. Draws in
        parameter order from ``generator``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear)):
                    trunc_normal_init(m.weight, generator)
                    m.bias.zero_()
                elif isinstance(m, LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, ConvNeXtBlock) and m.gamma is not None:
                    m.gamma.fill_(m.layer_scale_init)

    # ---------------- pieces ----------------

    def _downsample(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if i == 0:
            return self.stem_norm(conv_nhwc(x, self.stem_conv, self.dtype))
        x = getattr(self, f"down{i}_norm")(x)
        return conv_nhwc(x, getattr(self, f"down{i}_conv"), self.dtype)

    def _features(self, x: torch.Tensor, keep: torch.Tensor | None = None,
                  collect: Sequence[int] = ()):
        """(stage-4 features [B, h, w, C], {stage: its output} for the
        stages in ``collect``); ``keep`` [n_blocks, B] the drop-path keep
        bits of every block, in order."""
        collected, k = {}, 0
        for i in range(4):
            x = self._downsample(x, i)
            for blk in self.stage_blocks(i):
                x = blk(x, None if keep is None else keep[k])
                k += 1
            if i in collect:
                collected[i] = x
        return x, collected

    def _pseudo_patch_grid(self, feats: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """[B, h/32, w/32, C] onto the ViT patch grid h/p x w/p."""
        if self.patch_size is None:
            return feats
        hp, wp = h // self.patch_size, w // self.patch_size
        if tuple(feats.shape[1:3]) == (hp, wp):
            return feats
        return resize_grid(feats, (hp, wp), method="bilinear",
                           antialias=True).to(feats.dtype)

    def _check_plan(self, train: bool, plan: dict | None) -> torch.Tensor | None:
        """The keep bits [n_blocks, B] a call consumes: none when
        deterministic; a training call with drop path must bring them
        (``rng/plan.py convnext_plan``)."""
        if not train or self.drop_path_rate == 0.0:
            return None
        keep = ((plan or {}).get("drop_path") or {}).get("keep")
        if keep is None:
            raise ValueError(
                "a training forward with drop_path_rate > 0 needs the step's "
                "drop-path keep bits (rng/plan.py convnext_plan)")
        return keep

    # ---------------- forwards ----------------

    def forward(self, x: torch.Tensor, masks: torch.Tensor | None = None, *,
                train: bool = False, plan: dict | None = None,
                crop_kind: str = "global") -> dict:
        """x [B, H, W, C] -> the ViT's output dict: x_norm_clstoken [B, C],
        x_storage_tokens [B, 0, C], x_norm_patchtokens [B, T, C],
        x_prenorm [B, T, C] (the pseudo patch tokens before the norm) and
        ``masks``, carried through: a convnet cannot mask tokens
        mid-stage, so masked positions hold the unmasked image's tokens.
        ``plan``: a training pass's {"drop_path": {"keep": [n_blocks, B]}};
        ``crop_kind`` is taken for the ViT's signature and changes
        nothing."""
        keep = self._check_plan(train, plan)
        B, H, W, _ = x.shape
        feats, _ = self._features(x, keep)
        feats = self._pseudo_patch_grid(feats, H, W)
        pooled = feats.mean(dim=(1, 2))
        tokens = feats.reshape(B, -1, feats.shape[-1])
        x_norm = self.norm(torch.cat([pooled[:, None], tokens], dim=1))
        return {
            "x_norm_clstoken": x_norm[:, 0],
            "x_storage_tokens": x_norm[:, 1:1],
            "x_norm_patchtokens": x_norm[:, 1:],
            "x_prenorm": tokens,
            "masks": masks,
        }

    def get_intermediate_layers(self, x: torch.Tensor, n=1, reshape: bool = False,
                                return_class_token: bool = False,
                                norm: bool = True) -> tuple:
        """Eval-time features of chosen stages, for images x [B, H, W, C].

        ``n``: an int takes the last n stages, a sequence the stages at
        those indices. Only stage 4 has a trained norm and is resized onto
        the patch grid; earlier stages come back raw, as in the JAX
        package. Each entry is the tokens [B, T, C] (``reshape``: [B, h,
        w, C], channels last as in the JAX package), paired with the pooled
        token [B, C] under ``return_class_token``."""
        B, H, W, _ = x.shape
        take = list(range(4 - n, 4)) if isinstance(n, int) else [int(i) for i in n]
        _, collected = self._features(x, collect=take)
        outputs = []
        for i in take:
            feats = collected[i]
            if i == 3:
                feats = self._pseudo_patch_grid(feats, H, W)
            pooled = feats.mean(dim=(1, 2))
            tokens = feats.reshape(B, -1, feats.shape[-1])
            if norm and i == 3:
                normed = self.norm(torch.cat([pooled[:, None], tokens], dim=1))
                pooled, tokens = normed[:, 0], normed[:, 1:]
            if reshape:
                tokens = tokens.reshape(B, feats.shape[1], feats.shape[2], -1)
            outputs.append((tokens, pooled) if return_class_token else tokens)
        return tuple(outputs)


# the architecture table of the JAX package
CONVNEXT_SIZES = {
    "tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "test": dict(depths=(1, 1, 2, 1), dims=(8, 16, 32, 64)),
}


def get_convnext_arch(arch_name: str):
    """"convnext_tiny" -> its constructor (kwargs override the table)."""
    size = arch_name.split("_", 1)[1]
    if size not in CONVNEXT_SIZES:
        raise ValueError(
            f"unknown convnext size {size!r} (have {sorted(CONVNEXT_SIZES)})")
    table = CONVNEXT_SIZES[size]

    def ctor(**kwargs) -> ConvNeXt:
        return ConvNeXt(**{**table, **kwargs})

    return ctor


def convnext_kwargs_from_cfg(cfg, *, teacher: bool = True) -> dict:
    """``student`` section -> ``ConvNeXt`` kwargs; the teacher (and eval)
    backbone takes no drop path. An override ``+student.depths=[a,b,c,d]``
    (a key the schema lacks) cuts the stage depths, for runs at full
    width."""
    from dinov3_tpu_torch.ops.common import Policy

    s = cfg.student
    depth = {} if s.get("depths") is None else {"depths": tuple(int(d) for d in s.depths)}
    return dict(**depth,
                drop_path_rate=0.0 if teacher else float(s.drop_path_rate),
                layer_scale_init=s.layerscale,
                in_chans=s.in_chans,
                patch_size=s.patch_size,
                dtype=Policy.from_cfg(cfg.compute_precision).compute_dtype)
