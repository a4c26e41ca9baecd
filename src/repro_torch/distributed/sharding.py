"""Logical-axis → mesh-axis sharding rules (MaxText-style; counterpart of
``repro.distributed.sharding``) on ``torch.distributed``'s ``DeviceMesh``
and DTensor placements.

Every parameter carries logical axis names (``models/specs.py``).  This
module maps them onto the mesh:

* ``model`` — tensor parallelism: "vocab", "q_heads", "mlp", "mlp2",
  "heads_ssm" and "experts" (pure EP when the expert count divides the
  axis; otherwise experts stay unsharded and their FFN shards on "mlp").
* ``data`` — FSDP: the "embed" (d_model) dimension of weight matrices
  shards over data, so parameters AND optimizer state scale down with the
  full rank count.  DTensor inserts the weight all-gathers.
* ``pod`` — outer data parallelism only (batch); parameters are
  replicated across pods.

Families can override: xLSTM replicates everything (4 heads, d_model 768:
TP would pad 4x) and shards the batch over all three axes instead.

**Layout.**  A JAX ``PartitionSpec`` maps each *tensor* dim to mesh axes;
DTensor's ``placements`` map each *mesh* dim to ``Shard(tensor_dim)`` or
``Replicate()``.  :func:`spec_for_array` computes the reference's spec
(a tuple: per tensor dim a mesh-axis name, a tuple of names, or None,
trailing Nones dropped) and :func:`placements` transposes it.  A batch dim
over several mesh axes (``("pod", "data")``) becomes ``Shard(0)`` on each
of those mesh dims; DTensor splits a dim sharded on several mesh dims in
mesh-dim order, so the block layout is JAX's only when the mesh orders its
dims as the tuple does (``pod`` before ``data`` before ``model``, as
``launch/mesh.py`` builds them).

A mesh is anything with ``mesh_dim_names`` and a ``shape`` of sizes (a
``DeviceMesh``), or with a ``shape`` dict of axis sizes in mesh-dim order
(the reference's ``Mesh``); only :func:`distribute` needs a real
``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: dict
    batch_axes: tuple = ("pod", "data")   # activation batch sharding
    replicate_params: bool = False

    def axis_for(self, logical: str) -> Optional[str]:
        return None if self.replicate_params else self.rules.get(logical)

    @property
    def tensor_axis(self) -> Optional[str]:
        """The mesh axis of tensor parallelism: where the rules put the
        FFN dim (and with it the heads and the vocab)."""
        return self.axis_for("mlp")


DEFAULT_RULES = {
    "vocab": "model",
    "q_heads": "model",
    "mlp": "model",
    "mlp2": "model",
    "experts": "model",
    "experts_unsharded": None,
    "router_experts": None,
    "kv_heads": None,       # replicated under TP (exact GQA)
    "head": None,
    "embed": "data",        # FSDP: weight matrices shard d_model over data
    "embed2": "data",
    "heads_ssm": "model",
    "state": None,
    "conv": None,
    "layers": None,
    "sites": None,
    "pos": None,
}


def rules_for(family: str) -> ShardingRules:
    if family == "xlstm":
        return ShardingRules(rules={}, replicate_params=True,
                             batch_axes=("pod", "data", "model"))
    return ShardingRules(rules=DEFAULT_RULES)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A DTensor layout: the mesh and one placement a mesh dim (a leaf of
    the port's trees, where a NamedTuple would be a node)."""
    mesh: object
    placements: tuple


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh-dim order."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, tuple(shape)))


def _trim(parts: list) -> tuple:
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_for_array(shape, axes, rules: ShardingRules, mesh) -> tuple:
    """The reference's ``_spec_for_array``: one mesh axis per tensor dim,
    each mesh axis used once, a dim sharded only when the axis size
    divides it."""
    sizes = axis_sizes(mesh)
    parts, used = [], set()
    for dim, logical in zip(shape, axes):
        mesh_axis = rules.axis_for(logical)
        if (mesh_axis is not None and mesh_axis in sizes
                and mesh_axis not in used
                and dim % sizes[mesh_axis] == 0):
            parts.append(mesh_axis)
            used.add(mesh_axis)
        else:
            parts.append(None)
    return _trim(parts)


def placements(spec: tuple, mesh) -> tuple:
    """The transpose of a spec: ``Shard(d)`` on each mesh dim that tensor
    dim ``d`` names, ``Replicate()`` on the others and on a mesh dim of
    size 1 (which holds the whole dim either way, while DTensor's view
    rules refuse to merge a dim sharded on it)."""
    out = []
    for name, size in axis_sizes(mesh).items():
        if size == 1:
            out.append(Replicate())
            continue
        dims = [d for d, part in enumerate(spec)
                if part == name or (isinstance(part, tuple) and name in part)]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} shards dims {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(mesh, spec: tuple) -> NamedSharding:
    return NamedSharding(mesh, placements(spec, mesh))


def logical_to_sharding(shape, axes, rules: ShardingRules,
                        mesh) -> NamedSharding:
    return named(mesh, spec_for_array(shape, axes, rules, mesh))


def is_axes(x) -> bool:
    """A spec tree's leaf: a tuple of logical axis names."""
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def map_specs(fn, specs, *trees):
    """``fn(axes, *leaves)`` over a spec tree (leaves: axis tuples) and
    trees of its structure; dicts keep their keys, lists and tuples their
    kind."""
    if is_axes(specs):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, s, *(t[i] for t in trees))
                           for i, s in enumerate(specs))
    raise TypeError(f"not a spec tree node: {specs!r}")


def param_shardings(params, specs, rules: ShardingRules, mesh):
    """Tree of :class:`NamedSharding` matching ``params`` (``specs``
    carries the logical-axes tuples)."""
    return map_specs(
        lambda ax, p: logical_to_sharding(tuple(p.shape), ax, rules, mesh),
        specs, params)


def batch_spec(sizes: dict, batch_axes: tuple, batch: int):
    """The batch dim's part of a spec: the batch axes present in the mesh
    whose running product divides ``batch`` (None when none does)."""
    chosen, size = [], 1
    for a in batch_axes:
        if a in sizes and batch % (size * sizes[a]) == 0:
            chosen.append(a)
            size *= sizes[a]
    return tuple(chosen) if chosen else None


def activation_sharding(mesh, rules: ShardingRules, batch: int,
                        *trailing) -> NamedSharding:
    """Batch-sharded activation layout: batch over the configured axes
    (those present in the mesh and dividing the batch), trailing dims as
    given (None: unsharded)."""
    b = batch_spec(axis_sizes(mesh), rules.batch_axes, batch)
    return named(mesh, _trim([b, *trailing]))


def cache_sharding(mesh, cache_leaf_shape, batch_dim: int,
                   seq_dim: Optional[int], heads_dim: Optional[int],
                   batch: int) -> NamedSharding:
    """Serve-cache layout: batch→data when divisible; heads→model when the
    (padded) head count divides, else seq→model."""
    sizes = axis_sizes(mesh)
    parts: list = [None] * len(cache_leaf_shape)
    if batch % sizes.get("data", 1) == 0 and batch > 1:
        parts[batch_dim] = "data"
    msize = sizes.get("model", 1)
    if (heads_dim is not None and cache_leaf_shape[heads_dim] % msize == 0
            and cache_leaf_shape[heads_dim] >= msize):
        parts[heads_dim] = "model"
    elif seq_dim is not None and cache_leaf_shape[seq_dim] % msize == 0:
        parts[seq_dim] = "model"
    return named(mesh, _trim(parts))


def distribute(tensor: torch.Tensor, sharding: NamedSharding):
    """``tensor`` (whole and equal on every rank) as a DTensor of the
    layout; each rank keeps its own block."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor, sharding.mesh, list(sharding.placements))
