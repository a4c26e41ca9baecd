"""Distribution plane (counterpart of ``repro.distributed``): gradient
compression and fault tolerance.  The sharding rules (``sharding.py``,
``autoshard.py``) are not yet ported."""

from repro_torch.distributed.compression import (
    get_compressor, int8_compressor, topk_compressor)
from repro_torch.distributed.fault import (
    FailureInjector, best_mesh_shape, preserved_global_batch, rebalance_accum)

__all__ = [
    "FailureInjector",
    "best_mesh_shape",
    "get_compressor",
    "int8_compressor",
    "preserved_global_batch",
    "rebalance_accum",
    "topk_compressor",
]
