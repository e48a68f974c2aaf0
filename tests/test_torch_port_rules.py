"""Rules of the PyTorch port: what it may import, the config copy it
carries, and the weight bridge against the JAX package's own converter."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dinov3_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dinov3_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_ab_step.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


# calls that end, fork or strip the process a test worker runs in
FORBIDDEN_CALLS = {("os", "_exit"), ("os", "fork"), ("os", "forkpty"),
                   ("gc", "disable")}
RULED_TESTS = ("test_torch_trainer.py", "test_torch_data.py")


def _called_attributes(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)):
            yield node.value.id, node.attr, node.lineno


@pytest.mark.parametrize("path", _port_files() + [REPO / "tests" / t for t in RULED_TESTS],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_exit_fork_or_gc_disable(path):
    """No ``os._exit``, ``os.fork`` or ``gc.disable`` in the port, its
    scripts or the trainer's and data pipeline's tests: a test worker that
    runs them dies or keeps a changed collector."""
    found = [f"{mod}.{attr} at line {line}" for mod, attr, line in _called_attributes(path)
             if (mod, attr) in FORBIDDEN_CALLS]
    assert not found, f"{path.name}: {found}"


def test_the_call_rule_sees_what_it_forbids(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import gc, os\ngc.disable()\nf = os._exit\nif os.fork():\n    pass\n")
    assert sorted((m, a) for m, a, _ in _called_attributes(bad) if (m, a) in FORBIDDEN_CALLS) \
        == [("gc", "disable"), ("os", "_exit"), ("os", "fork")]


def test_default_config_copy_equals_the_jax_one():
    ours = PORT / "configs" / "ssl_default_config.yaml"
    theirs = REPO / "dinov3_tpu" / "configs" / "ssl_default_config.yaml"
    assert ours.read_bytes() == theirs.read_bytes()


def test_config_loader_resolves_the_jax_tree():
    """Same run YAML and overrides -> the same tree, the learning rate
    scaled by the same global batch: the port's loader given the device
    count the JAX loader sees."""
    from dinov3_tpu.configs import load_config as jax_load
    from dinov3_tpu.configs.config import (
        continuous_packing_wished,
        serve_pad_waste_floor,
        serve_patch_features_wished,
    )

    from dinov3_tpu_torch.configs import load_config
    from dinov3_tpu_torch.configs import config as tc

    run = REPO / "configs" / "train" / "vitl16_im1k.yaml"
    overrides = ["serve.rows=2", "student.n_storage_tokens=4",
                 "serve.patch_features=true"]
    for extra in ([], ["optim.scaling_rule=linear_wrt_256",
                       "parallel.tensor=2"]):
        ours = load_config(run, overrides + extra,
                           n_devices=jax.device_count()).to_dict()
        theirs = jax_load(run, overrides + extra).to_dict()
        assert ours == theirs
    one = load_config(run, overrides)  # one card: lr * 4 * sqrt(64 / 1024)
    assert one.optim.lr == pytest.approx(1e-3 * 4 * (64 / 1024) ** 0.5)
    cfg = load_config(run, overrides)
    assert tc.continuous_packing_wished(cfg) == continuous_packing_wished(cfg)
    assert tc.serve_patch_features_wished(cfg)
    assert serve_patch_features_wished(cfg)
    assert tc.serve_pad_waste_floor(2050, 16, 1, 96, 512) == \
        serve_pad_waste_floor(2050, 16, 1, 96, 512)
    with pytest.raises(KeyError, match="unknown key"):
        load_config(run, ["serve.rowz=2"])


def _jax_backbone_params(scan_layers: bool):
    import flax.linen as nn

    from dinov3_tpu.configs import apply_dot_overrides, get_default_config
    from dinov3_tpu.models import build_backbone

    cfg = get_default_config()
    apply_dot_overrides(cfg, [
        "student.arch=vit_test", "student.patch_size=4",
        f"train.scan_layers={str(scan_layers).lower()}"])
    model = build_backbone(cfg, teacher=True)
    params = nn.meta.unbox(model.init(jax.random.key(0),
                                      jnp.zeros((1, 8, 8, 3))))["params"]
    return jax.tree.map(np.asarray, params)


def test_state_dict_from_jax_round_trips_through_the_jax_converter():
    """Unscanned tree with tied norms -> Meta-named state_dict -> the JAX
    package's torch converter -> the original tree, leaf for leaf."""
    from dinov3_tpu.interop.torch_convert import (
        _tree_paths,
        convert_torch_backbone_state_dict,
    )

    from dinov3_tpu_torch.interop import state_dict_from_jax
    from dinov3_tpu_torch.models import vit_test

    params = _jax_backbone_params(scan_layers=False)
    sd = state_dict_from_jax(params)
    assert sd["patch_embed.proj.weight"].shape == (64, 3, 4, 4)
    assert sd["blocks.0.attn.qkv.weight"].shape == (192, 64)
    assert sd["mask_token"].shape == (1, 64)
    back = _tree_paths(convert_torch_backbone_state_dict(sd))
    orig = _tree_paths(params)
    assert back.keys() == orig.keys()
    for path, v in orig.items():
        np.testing.assert_array_equal(np.asarray(back[path]), v,
                                      err_msg=".".join(path))
    # the keys are exactly the port model's state_dict keys
    model = vit_test(patch_size=4, layerscale_init=1e-5)
    model.load_state_dict(sd, strict=True)


def test_state_dict_from_jax_takes_the_scanned_tree():
    from dinov3_tpu_torch.interop import state_dict_from_jax

    scanned = _jax_backbone_params(scan_layers=True)
    stack = scanned["blocks"]["block"]
    unscanned = {k: v for k, v in scanned.items() if k != "blocks"}
    for i in range(2):
        unscanned[f"blocks_{i}"] = jax.tree.map(lambda a, i=i: a[i], stack)
    a, b = state_dict_from_jax(scanned), state_dict_from_jax(unscanned)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
