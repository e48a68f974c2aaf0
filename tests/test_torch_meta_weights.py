"""Meta-layout backbone weights in the port
(``dinov3_tpu_torch/interop/torch_convert.py``) on the CPU, fp32.

- The MLP layout: ``tests/torch_dinov3_oracle.py`` (the in-repo stand-in
  for a release checkpoint, read and not edited) gives a ``state_dict`` in
  the release's names and an independent forward; the port loads it and
  matches the forward within 1e-5 (the golden bound of
  ``tests/test_golden_parity.py`` is 1e-3), and the weights it loads are
  bitwise those the JAX converter reads from the same file.
- SwiGLU: the test writes the release's ``mlp.w1``/``w2``/``w3`` itself;
  the port's features match the JAX model whose fused ``w12`` the test
  concatenates from w1 and w2, within 1e-4 (whole-model fp32). The JAX
  converter itself refuses such a file (``ROADMAP.md`` §3).
- Serving and evals start from such a file: the engine's responses equal
  those of an engine given the same weights in the port's own names,
  bitwise, and the plain forward's within 2^-5 of the feature scale
  (bf16 serving weights, as in ``tests/test_torch_serve.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dinov3_oracle import TorchDinoViT

from dinov3_tpu_torch.interop import (
    convert_meta_state_dict,
    load_backbone_from_meta,
    state_dict_from_jax,
)


def _oracle(depth=2, embed_dim=64, num_heads=2, seed=0):
    torch.manual_seed(seed)
    oracle = TorchDinoViT(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                          patch_size=16, n_storage_tokens=4, ls_init=1e-5)
    with torch.no_grad():  # released weights are trained, not init-small
        for p in oracle.parameters():
            p.copy_(torch.randn_like(p) * 0.02)
    return oracle.eval()


def _port_vit(**kw):
    from dinov3_tpu_torch.models.vision_transformer import DinoVisionTransformer

    args = dict(patch_size=16, embed_dim=64, n_blocks=2, num_heads=2, n_storage_tokens=4,
                mask_k_bias=True, layerscale_init=1e-5, dtype=torch.float32)
    args.update(kw)
    return DinoVisionTransformer(**args).float().eval()


@pytest.mark.parametrize("res", [(64, 64), (48, 80)])
def test_meta_loader_on_the_mlp_layout_matches_the_oracle(res):
    oracle = _oracle()
    model = _port_vit()
    report = load_backbone_from_meta(model, oracle.state_dict())
    assert report == {"missing": [], "unexpected": [], "mismatched": []}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, *res, 3)).astype(np.float32))
    with torch.no_grad():
        want, got = oracle(x), model(x)
    for key in ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-5,
                                   err_msg=key)


def test_meta_loader_agrees_with_the_jax_converter():
    """The JAX converter's parameter tree of the same file, bridged to the
    port's names, equals the port loader's weights bit for bit."""
    from dinov3_tpu.interop.torch_convert import load_backbone_from_torch
    from dinov3_tpu.models import DinoVisionTransformer as JViT

    oracle = _oracle(seed=3)
    jm = JViT(patch_size=16, embed_dim=64, n_blocks=2, num_heads=2, ffn_ratio=4.0,
              n_storage_tokens=4, mask_k_bias=True, layerscale_init=1e-5,
              dtype=jnp.float32, param_dtype=jnp.float32)
    variables = load_backbone_from_torch(jm, oracle.state_dict(),
                                         example_shape=(1, 64, 64, 3))
    via_jax = state_dict_from_jax(jax.tree.map(np.asarray, variables["params"]))
    model = _port_vit()
    load_backbone_from_meta(model, oracle.state_dict())
    got = model.state_dict()
    assert got.keys() == via_jax.keys()
    for k, v in via_jax.items():
        assert torch.equal(got[k], v), k


def meta_swiglu_state_dict(port_sd: dict) -> dict:
    """A port SwiGLU ``state_dict`` written in the release's names: each
    fused ``w12`` split into ``w1`` (gate) and ``w2`` (value), plus the
    RoPE periods and qkv bias masks a release carries."""
    out = {"rope_embed.periods": torch.arange(8, dtype=torch.float32)}
    for k, v in port_sd.items():
        if ".mlp.w12." in k:
            w1, w2 = v.chunk(2, dim=0)
            out[k.replace(".w12.", ".w1.")] = w1.clone()
            out[k.replace(".w12.", ".w2.")] = w2.clone()
        else:
            out[k] = v.clone()
        if k.endswith("attn.qkv.bias"):  # the release's 0/1 mask of the k third
            mask = torch.ones_like(v)
            mask[v.shape[0] // 3: 2 * v.shape[0] // 3] = 0
            out[k + "_mask"] = mask
    return out


def test_swiglu_meta_state_dict_loads_and_matches_jax():
    """A SwiGLU backbone (patch 14, 4 storage tokens) in the release's
    names: the port loads it strictly; the JAX model holding the ``w12``
    the test concatenates from w1 and w2 gives the same features."""
    from dinov3_tpu.interop.torch_convert import convert_torch_backbone_state_dict
    from dinov3_tpu.models import DinoVisionTransformer as JViT

    src = _port_vit(patch_size=14, ffn_layer="swiglu")
    src.init_weights(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    meta = meta_swiglu_state_dict(src.state_dict())
    assert "blocks.0.mlp.w1.weight" in meta and "blocks.0.mlp.w12.weight" not in meta
    model = _port_vit(patch_size=14, ffn_layer="swiglu")
    assert load_backbone_from_meta(model, meta) == {
        "missing": [], "unexpected": [], "mismatched": []}
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    fused = {k: v for k, v in meta.items() if ".mlp.w2." not in k}
    for k in [k for k in fused if ".mlp.w1." in k]:
        fused[k.replace(".w1.", ".w12.")] = torch.cat(
            [fused.pop(k), meta[k.replace(".w1.", ".w2.")]], dim=0)
    params = jax.tree.map(np.asarray, convert_torch_backbone_state_dict(fused))
    jm = JViT(patch_size=14, embed_dim=64, n_blocks=2, num_heads=2, ffn_ratio=4.0,
              ffn_layer="swiglu", n_storage_tokens=4, mask_k_bias=True,
              layerscale_init=1e-5, attn_impl="pallas", dtype=jnp.float32,
              param_dtype=jnp.float32)
    x = np.random.default_rng(6).standard_normal((2, 28, 42, 3)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   err_msg=key)


def test_the_jax_converter_refuses_a_swiglu_state_dict():
    """The reference's loader maps ``mlp.w1``/``w2`` one to one while its
    ``SwiGLUFFN`` holds a fused ``w12``: strict loading reports ``w12``
    missing and ``w1``/``w2`` unexpected. The port fuses them."""
    from dinov3_tpu.interop.torch_convert import load_backbone_from_torch
    from dinov3_tpu.models import DinoVisionTransformer as JViT

    src = _port_vit(patch_size=14, ffn_layer="swiglu")
    meta = meta_swiglu_state_dict(src.state_dict())
    jm = JViT(patch_size=14, embed_dim=64, n_blocks=2, num_heads=2, ffn_ratio=4.0,
              ffn_layer="swiglu", n_storage_tokens=4, mask_k_bias=True,
              layerscale_init=1e-5, dtype=jnp.float32, param_dtype=jnp.float32)
    with pytest.raises(ValueError, match=r"missing=\[.*w12.*unexpected=\[.*w1"):
        load_backbone_from_torch(jm, meta, example_shape=(1, 28, 28, 3))
    assert set(convert_meta_state_dict(meta)) == set(src.state_dict())


def test_meta_loader_reports_what_does_not_fit():
    oracle = _oracle()
    sd = dict(oracle.state_dict())
    sd.pop("blocks.1.ls2.gamma")
    sd["head.weight"] = torch.zeros(3)
    sd["norm.bias"] = torch.zeros(5)
    with pytest.raises(ValueError, match="missing=.*ls2.*unexpected=.*head.*mismatched=.*norm"):
        load_backbone_from_meta(_port_vit(), sd)
    model = _port_vit()
    report = load_backbone_from_meta(model, sd, strict=False)
    assert report == {"missing": ["blocks.1.ls2.gamma"], "unexpected": ["head.weight"],
                      "mismatched": ["norm.bias"]}
    assert torch.equal(model.blocks[0].attn.qkv.weight, oracle.blocks[0].attn.qkv.weight)


SERVE = ["student.arch=vit_test", "student.patch_size=4", "student.ffn_layer=swiglu",
         "student.n_storage_tokens=4", "student.mask_k_bias=true", "serve.min_px=8",
         "serve.max_px=24", "serve.rows=3", "serve.row_tokens=48",
         "serve.max_segments_per_row=6"]


def test_serving_and_evals_start_from_a_meta_weights_file(tmp_path):
    from dinov3_tpu_torch.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu_torch.models import build_backbone, build_model_for_eval
    from dinov3_tpu_torch.serve import build_serve_engine
    from test_torch_serve import _drain, _images

    cfg = get_default_config()
    apply_dot_overrides(cfg, SERVE)
    src = build_backbone(cfg, device="cpu", seed=9)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    path = tmp_path / "dinov3_vit_test_swiglu.pth"
    torch.save(meta_swiglu_state_dict(src.state_dict()), path)
    ev = build_model_for_eval(cfg, device="cpu", meta_weights=str(path))
    for k, v in src.state_dict().items():
        assert torch.equal(ev.state_dict()[k], v), k
    got = _drain(build_serve_engine(cfg, meta_weights=str(path), device="cpu", warn=False),
                 _images())
    want = _drain(build_serve_engine(cfg, src.state_dict(), device="cpu", warn=False),
                  _images())
    assert sorted(got) == sorted(want) == list(range(len(_images())))
    scale = max(np.abs(r.cls_feature).max() for r in want.values())
    for i, im in enumerate(_images()):
        np.testing.assert_array_equal(got[i].cls_feature, want[i].cls_feature)
        with torch.no_grad():
            plain = src(torch.from_numpy(im)[None])["x_norm_clstoken"][0].float().numpy()
        np.testing.assert_allclose(got[i].cls_feature, plain, atol=2.0 ** -5 * scale)
    with pytest.raises(ValueError, match="alternatives"):
        build_serve_engine(cfg, src.state_dict(), meta_weights=str(path), device="cpu")
