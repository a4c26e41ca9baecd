"""Distribution plane (counterpart of ``repro.distributed``): sharding
rules (``sharding.py``) and activation constraints (``autoshard.py``) on
``torch.distributed``'s DeviceMesh and DTensor placements, gradient
compression and fault tolerance."""

from repro_torch.distributed.compression import (
    get_compressor, int8_compressor, topk_compressor)
from repro_torch.distributed.fault import (
    FailureInjector, best_mesh_shape, preserved_global_batch, rebalance_accum)
from repro_torch.distributed.sharding import (
    ShardingRules,
    activation_sharding,
    logical_to_sharding,
    param_shardings,
    rules_for,
)

__all__ = [
    "FailureInjector",
    "ShardingRules",
    "activation_sharding",
    "best_mesh_shape",
    "get_compressor",
    "int8_compressor",
    "logical_to_sharding",
    "param_shardings",
    "preserved_global_batch",
    "rebalance_accum",
    "rules_for",
    "topk_compressor",
]
