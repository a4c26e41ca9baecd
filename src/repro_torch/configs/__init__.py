"""Architecture configs: one module per assigned architecture + registry
(counterpart of ``repro.configs``)."""

from repro_torch.configs.base import (ModelConfig, active_param_count,
                                      param_count)
from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "ModelConfig", "active_param_count", "get_config",
           "list_archs", "param_count"]
