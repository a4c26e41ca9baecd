"""Production mesh construction (counterpart of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.  Both build a ``DeviceMesh`` with
``init_device_mesh`` over the default process group, which the caller has
initialised with the mesh's rank count (``torch.distributed``'s
``init_process_group``: backend, address, world size and rank are the
caller's, as nothing on a machine tells a program of its cluster).  A
CUDA mesh over a gloo group (ranks sharing one card) routes DTensor's
all-gathers through ``distributed/gloo_cuda.py``.
"""

from __future__ import annotations

from typing import Optional


def _mesh(shape: tuple, names: tuple, device_type: Optional[str]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for n in shape:
        need *= n
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh {names} needs a process "
            f"group of {need} ranks; call "
            f"torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh {names} needs {need} "
            f"ranks; the process group has {world}")
    from repro_torch.device import resolve_device

    kind = resolve_device(device_type).type
    if kind == "cuda" and dist.get_backend() == "gloo":
        # ranks sharing one card: see distributed/gloo_cuda.py
        from repro_torch.distributed.gloo_cuda import (
            route_gloo_cuda_all_gather)

        route_gloo_cuda_all_gather()
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: ``data`` carries batch + FSDP weight sharding; ``model`` carries
    tensor/expert parallelism; ``pod`` (multi-pod only) is outer data
    parallelism.  ``device_type`` is CUDA unless the caller names another
    (it raises without a card, as every entry point of the port).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 4, n_model: int = 2,
                    device_type: Optional[str] = None):
    """Small ``(data, model)`` mesh for multi-rank tests."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
