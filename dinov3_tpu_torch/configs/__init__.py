from dinov3_tpu_torch.configs.config import (
    ConfigNode,
    apply_dot_overrides,
    get_default_config,
    load_config,
)

__all__ = ["ConfigNode", "apply_dot_overrides", "get_default_config",
           "load_config"]
