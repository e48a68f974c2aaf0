from dinov3_tpu_torch.configs.config import (
    ConfigNode,
    apply_dot_overrides,
    get_default_config,
    global_batch_size,
    load_config,
    setup_job,
)

__all__ = ["ConfigNode", "apply_dot_overrides", "get_default_config",
           "global_batch_size", "load_config", "setup_job"]
