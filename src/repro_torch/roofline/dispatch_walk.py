"""One rank's work in an eager step, tallied at PyTorch's dispatcher
(counterpart of ``repro.roofline.hlo_walk``, which reads the terms from
compiled HLO text).

Eager PyTorch has no HLO: a step is the sequence of aten ops it
dispatches.  :class:`DispatchWalk` is a ``TorchDispatchMode`` that sees
each of them on one rank and tallies three terms:

1. **Matmul FLOPs** by ``torch.utils.flop_counter``'s formulas (2·|out|·K
   for ``mm``/``bmm``/``addmm``/``baddbmm``, and its convolution and
   attention formulas), by dtype.  Each rank's *local* ops are counted,
   each once:

   * an op on DTensors is handed back to DTensor (``NotImplemented``),
     which desugars it into the rank's local op on its shards and the
     collectives it needs; the mode then sees those, as
     ``CommDebugMode`` does.  So the ops DTensor runs itself (the tied
     LM head's products, which no ``local_map`` wraps) are counted on
     their local shapes, like the ops ``distributed/layout.py`` runs per
     rank through ``local_map``;
   * DTensor's sharding propagation runs each new op once more on fake
     tensors of the *global* shapes to learn its output's metadata;
     those runs happen under a ``FakeTensorMode`` and are skipped (they
     are no work, and their number depends on DTensor's cache).

   Ops inside a rolled loop do not exist here: Python loops run every
   trip, so no trip count is parsed (the reference multiplies ``while``
   bodies by parsed trip counts).
2. **HBM bytes at kernel boundaries.**  Eager PyTorch runs each non-view
   op as its own kernel(s), so every non-view op reads its tensor
   operands and writes its result once; views, ``empty`` factories and
   the functional collectives' ``wait_tensor`` move nothing.  This is
   eager's counterpart of the reference's fusion-boundary bytes
   (``hlo_walk.py:146-180``), and it is not held to the reference's
   number: XLA fuses elementwise chains into one kernel whose
   intermediates never reach HBM, while eager writes each intermediate
   out and reads it back, so the same step moves several times the bytes
   here.
3. **Collectives by kind with their bytes.**  The ``_c10d_functional``
   collectives DTensor issues, DTensor's shard-dim all-to-all and the
   ``c10d`` ops of ``torch.distributed``'s own calls (``GroupCollectives``
   in ``core/engine.py``), each with its result bytes, its group size and
   the global ranks of its group (read from the group it names), for
   ``analysis.collective_bytes``' ring conventions and the link it runs
   on.  A shard-dim all-to-all is counted as the all-to-all DTensor asked
   for: on a CPU-typed mesh DTensor falls back to an all-gather and a
   chunk, which would otherwise read as an all-gather (the mode wraps
   ``placement_types.shard_dim_alltoall`` while it is entered, and tallies
   nothing of the fallback's own ops).

On the meta device and a fake process group the same walk prices a step
at any width and rank count without memory or communication
(``launch/dryrun.py``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# (namespace, op name) -> (kind, index of the group argument); the
# result's bytes are the output's (in place: the first argument's)
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", 2),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", 2),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", 2),
    ("_c10d_functional", "all_reduce_coalesced_"): ("all-reduce", 2),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 2),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all-gather", 2),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", 2),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 3),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", 3),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 3),
    ("_dtensor", "shard_dim_alltoall"): ("all-to-all", 3),
    ("c10d", "allreduce_"): ("all-reduce", 1),
    ("c10d", "allgather_"): ("all-gather", 2),
    ("c10d", "_allgather_base_"): ("all-gather", 2),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 2),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 2),
    ("c10d", "alltoall_base_"): ("all-to-all", 2),
}
# the collectives' bookkeeping: no data moves
_BOOKKEEPING = {("_c10d_functional", "wait_tensor"),
                ("_c10d_functional", "_wrap_tensor_autograd"),
                ("c10d", "barrier")}
_FREE = {"_unsafe_view", "lift_fresh", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided"}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective on one rank: its kind, its result's bytes (the
    reference's HLO line's left-hand shape), its group's size and global
    ranks."""
    kind: str
    nbytes: int
    group_size: int
    ranks: tuple


def _tensors(tree) -> list:
    out, seen = [], set()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_ranks(group) -> tuple:
    import torch.distributed as dist

    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    elif isinstance(group, torch.ScriptObject):
        group = dist.ProcessGroup.unbox(group)
    return tuple(dist.get_process_group_ranks(group))


def _in_fake_mode(types) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return (torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None
        or any(issubclass(t, FakeTensor) for t in types))


class DispatchWalk(TorchDispatchMode):
    """Tally one rank's matmul FLOPs, HBM bytes and collectives over the
    ops dispatched while it is entered (see the module docstring);
    :meth:`summary` gives them under ``hlo_walk.walk``'s keys."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._formulas = FlopCounterMode(display=False).flop_registry
        self.flops_by_dtype: dict = collections.Counter()
        self.flops_by_op: dict = collections.Counter()
        self.dot_count = 0
        self.hbm_bytes = 0
        self.collectives: list[Collective] = []
        self._quiet = 0
        self._patched = None

    # -- shard-dim all-to-all: counted as asked for -----------------------
    def _wrap_alltoall(self, real: Callable) -> Callable:
        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._quiet += 1
            try:
                out = real(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._quiet -= 1
            if not self._quiet:
                ranks = _group_ranks(mesh.get_group(mesh_dim))
                self.collectives.append(Collective(
                    "all-to-all", _nbytes(out), len(ranks), ranks))
                self.hbm_bytes += _nbytes(input) + _nbytes(out)
            return out

        return shard_dim_alltoall

    def __enter__(self):
        try:
            from torch.distributed.tensor import placement_types
        except ImportError:
            placement_types = None
        real = getattr(placement_types, "shard_dim_alltoall", None)
        if real is not None:
            self._patched = (placement_types, real)
            placement_types.shard_dim_alltoall = self._wrap_alltoall(real)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._patched is not None:
                module, real = self._patched
                module.shard_dim_alltoall = real
                self._patched = None

    # -- the dispatcher ---------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs the rank's local ops
        out = func(*args, **kwargs)
        if self._quiet or _in_fake_mode(types):
            return out
        self._tally(func, args, kwargs, out)
        return out

    def _tally(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns, _, name = packet._qualified_op_name.partition("::")
        if (ns, name) in _BOOKKEEPING:
            return
        coll = _COLLECTIVES.get((ns, name))
        if coll is None and ns in ("_c10d_functional", "c10d", "_dtensor"):
            raise NotImplementedError(f"DispatchWalk: collective {ns}::"
                                      f"{name} is not priced")
        if coll is not None:
            kind, g = coll
            ranks = _group_ranks(args[g])
            res = out if ns != "c10d" else args[0]
            self.collectives.append(Collective(kind, _nbytes(res),
                                               len(ranks), ranks))
        out_tensors = _tensors(out)
        if func.is_view or name in _FREE or not out_tensors:
            return
        self.hbm_bytes += _nbytes((args, kwargs)) + _nbytes(out_tensors)
        formula = self._formulas.get(packet)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            self.flops_by_dtype[str(out_tensors[0].dtype)] += flops
            self.flops_by_op[str(packet)] += flops
            self.dot_count += 1

    # -- results ----------------------------------------------------------
    @property
    def matmul_flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def summary(self) -> dict:
        """``hlo_walk.walk``'s keys (``unresolved_trip_counts`` and
        ``num_computations`` have no eager meaning: ``None``), plus the
        FLOPs by dtype and by op and the collectives."""
        from repro_torch.roofline.analysis import collective_bytes

        coll = collective_bytes(self.collectives)
        return {
            "matmul_flops": self.matmul_flops,
            "dot_count": self.dot_count,
            "collective": {k: v for k, v in coll.items() if k != "count"},
            "collective_count": coll["count"],
            "hbm_bytes": self.hbm_bytes,
            "unresolved_trip_counts": None,
            "num_computations": None,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "flops_by_op": dict(self.flops_by_op),
            "collectives": list(self.collectives),
        }


def walk(fn: Callable, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), summary)`` of one rank's work in the call."""
    with DispatchWalk() as w:
        out = fn(*args, **kwargs)
    return out, w.summary()
