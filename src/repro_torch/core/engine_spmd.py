"""Multi-rank execution of the OLA-RAW engine on ``torch.distributed``
(counterpart of ``repro.core.engine_spmd``).

The worker axis is split over the ranks of the mesh's ``data`` dimension
(EXTRACT threads become devices): one program runs on each rank, the
rank's ``num_workers / ranks`` workers are its shard of the worker axis,
and every other piece of engine state is replicated and advanced by
all-reduced deltas, so every rank holds identical state.  This is the
counterpart of the reference's ``shard_map`` with ``cur`` sharded over
``data``: ``cur`` and ``speeds`` hold the rank's slice, the slot table,
the statistics, the cache and the schedule are whole on every rank.

Semantics are those of the single-device engine with ``num_workers =
ranks × workers_per_rank``, bit for bit, whatever the rank count: the
claim step's prefix sum runs over the gathered idle flags in global worker
order, so chunk hand-out is the single-device one, and every merged
quantity is exact (:class:`~repro_torch.core.engine.GroupCollectives`).
Under ``residency="packed"`` every rank holds the whole packed store on
its device; under ``"stream"`` each rank's
:class:`~repro_torch.data.pipeline.SlabPrefetcher` assembles the chunks its
own workers claim (its read-ahead warms the schedule's next chunks on every
rank).

``mesh`` is a :class:`torch.distributed.device_mesh.DeviceMesh` with a
``"data"`` dimension; the engine takes that dimension's process group and
its local rank.  The group's backend follows the layout: NCCL with one GPU
per rank, gloo on the CPU and for several ranks sharing one GPU (NCCL
refuses two ranks on one device; gloo stages each reduction of CUDA
tensors through the host).  The engine's own ``device`` (CUDA unless the
caller names another; it raises without a card) is where its tensors
live.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.engine import (
    EngineConfig,
    GroupCollectives,
    OLAEngine,
    SlotOLAEngine,
)
from repro_torch.core.queries import Query
from repro_torch.device import resolve_device


def mesh_group(mesh) -> tuple[object, int, int]:
    """``(group, rank, ranks)`` of the mesh's ``data`` dimension."""
    names = tuple(mesh.mesh_dim_names or ())
    if "data" not in names:
        raise ValueError(f"the mesh has no 'data' dimension ({names})")
    return (mesh.get_group("data"), mesh.get_local_rank("data"),
            mesh.size(names.index("data")))


class _SPMDEngineBase:
    """The rank's place in the mesh: the worker split over the ``data``
    ranks and the rank's collectives.  Everything else is the
    single-device engine's, which reads ``coll`` for the rank's slice of
    the workers, its speeds and ``cur``, and its slab."""

    def _join_mesh(self, config: EngineConfig, mesh, device) -> None:
        self.mesh = mesh
        group, self.rank, self.n_dev = mesh_group(mesh)
        assert config.num_workers % self.n_dev == 0, (
            f"num_workers={config.num_workers} must divide over "
            f"data axis size {self.n_dev}")
        self.wpd = config.num_workers // self.n_dev
        self.coll = GroupCollectives(group, self.rank, self.n_dev, self.wpd,
                                     resolve_device(device))


class SPMDEngine(_SPMDEngineBase, OLAEngine):
    """Multi-rank OLA engine for a frozen query list over a mesh with a
    ``data`` dimension.  Its ``run`` is the single-device loop, whose
    wall-clock cut is agreed across the ranks (``agree``), so every rank
    stops after the same round."""

    def __init__(self, store, queries: Sequence[Query], config: EngineConfig,
                 mesh, schedule=None, device=None):
        self._join_mesh(config, mesh, device)
        super().__init__(store, queries, config, schedule=schedule,
                         device=device)


class SlotSPMDEngine(_SPMDEngineBase, SlotOLAEngine):
    """Multi-rank slot-table engine:
    :class:`~repro_torch.core.engine.SlotOLAEngine` with the worker axis
    split over the mesh's ``data`` ranks.  The workload server drives
    either through the same ``round_fn(b)(state, table, data, speeds)``
    step; the slot table is replicated."""

    def __init__(self, store, max_slots: int, config: EngineConfig, mesh,
                 schedule=None, confidence: float = 0.95, device=None):
        self._join_mesh(config, mesh, device)
        super().__init__(store, max_slots, config, schedule=schedule,
                         confidence=confidence, device=device)
