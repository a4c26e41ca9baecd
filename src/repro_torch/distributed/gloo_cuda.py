"""DTensor's all-gather over gloo for CUDA tensors.

Ranks that share one card cannot use NCCL (it refuses two ranks on one
device), so a mesh of such ranks runs gloo over CUDA tensors, which gloo
stages through the host.  On torch 2.11 (+cu128) DTensor's all-gather,
the functional collective ``_c10d_functional.all_gather_into_tensor``,
crashes the process with a segmentation fault in ``wait_tensor`` on such
a group, while the blocking ``torch.distributed.all_gather_into_tensor``
on the same group works, as do the functional all-reduce, reduce-scatter
and all-to-all (probed on an H100 80GB HBM3, 4 gloo ranks).

:func:`route_gloo_cuda_all_gather` replaces
``torch.distributed._functional_collectives.all_gather_tensor``, which
DTensor's Shard → Replicate redistribution calls (``all_gather_single`` in
later versions), by a version that, for a
CUDA tensor on a gloo group, gathers with the blocking c10d call (same
layout: gathered along dim 0, then moved to ``gather_dim``); everything
else goes to the original.  The result is an ordinary tensor, which
DTensor takes as the functional call's completed result.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_STATE: dict = {}


def _process_group(group):
    """The ``ProcessGroup`` of a functional collective's ``group``
    argument, or None when it names one another way (a rank list)."""
    if isinstance(group, dist.ProcessGroup):
        return group
    if isinstance(group, tuple) and len(group) == 2:
        mesh, mesh_dim = group
        return mesh.get_group(mesh_dim)
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(group)
    return None


def _gloo_cuda_all_gather(original):
    def all_gather_tensor(self: torch.Tensor, gather_dim: int, group,
                          tag: str = ""):
        pg = _process_group(group) if self.is_cuda else None
        if pg is None or dist.get_backend(pg) != "gloo":
            return original(self, gather_dim, group, tag)
        world = dist.get_world_size(pg)
        src = self.contiguous()
        out = src.new_empty((world * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=pg)
        if gather_dim != 0:
            out = torch.cat(torch.chunk(out, world, dim=0), dim=gather_dim)
        return out

    return all_gather_tensor


def route_gloo_cuda_all_gather() -> None:
    """Install the routing (once a process; idempotent) on
    ``all_gather_tensor`` and, where the torch in use has it (later
    versions call it from DTensor instead), ``all_gather_single``."""
    import torch.distributed._functional_collectives as funcol

    if _STATE.get("installed"):
        return
    for name in ("all_gather_tensor", "all_gather_single"):
        if hasattr(funcol, name):
            setattr(funcol, name, _gloo_cuda_all_gather(getattr(funcol, name)))
    _STATE["installed"] = True
