"""One rank's work in an eager step, tallied at PyTorch's dispatcher
(counterpart of ``repro.roofline.hlo_walk``, which reads the terms from
compiled HLO text).

Eager PyTorch has no HLO: a step is the sequence of aten ops it
dispatches.  :class:`DispatchWalk` is a ``TorchDispatchMode`` that sees
each of them on one rank and tallies four terms:

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

4. **Live bytes.**  Every storage an op's output brings into being is
   allocated when the walk first sees it (a non-view op's result, the
   ``empty`` factories included, which move no HBM bytes); a view, an
   in-place op or an ``out=`` op on a known storage allocates nothing.
   A storage is freed when it dies (``StorageWeakRef.expired()``, which
   works on meta storages as on real ones).  The step's arguments, given
   as ``hold`` (a module: its parameters and buffers), are *held*: live
   for the whole step, since the caller keeps them.  Any other storage
   an op reads that the walk has not seen is the step's own from that
   op on: a tensor the step makes outside the dispatcher
   (``torch.tensor(...)``) is first seen as an operand.  Each storage is
   rounded up to an allocation ``granule``: ``CUDA_ALLOC_GRANULE``
   (512 B, the steps in which the CUDA caching allocator counts
   ``memory_allocated``) for the card, 1 B for hand checks.  The walk
   keeps the high-water mark of the step's own live bytes after any op
   (``temp_peak_bytes``), the op and its index; ``peak_bytes`` adds the
   held bytes.  Dead storages are
   swept only when the running total, which still counts the dead ones
   not yet swept, exceeds the mark: only then could a new mark be set, so
   the mark is exact without a scan of every live storage at every op.
   Above 1 MiB the running total must pass the mark by 1/4096 of it
   (``SWEEP_SLACK_SHIFT``) before a sweep: the mark is then within that
   share below the step's true high-water mark, and a step whose live
   bytes grow over many ops (a recurrence over thousands of time steps,
   each op a little above the last mark) sweeps once every 1/4096 of
   growth rather than at every op.
   What no dispatcher sees is not counted: an op's own scratch freed
   before it returns, and what a C++ backend allocates on its own
   threads (gloo's staging of CUDA tensors).

On the meta device and a fake process group the same walk prices a step
at any width and rank count without memory or communication
(``launch/dryrun.py``).  ``trace=True`` also keeps one line per op (its
shapes, FLOPs, HBM bytes and the live bytes after it, swept at every op)
for :meth:`DispatchWalk.write_trace`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import (
    TorchDispatchMode, is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_leaves

# the CUDA caching allocator counts its blocks in 512-byte steps
CUDA_ALLOC_GRANULE = 512
# above SWEEP_EXACT_BELOW bytes a sweep waits for the running total to
# pass the mark by mark >> SWEEP_SLACK_SHIFT (see the module docstring)
SWEEP_EXACT_BELOW = 1 << 20
SWEEP_SLACK_SHIFT = 12

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
    ranks; the local shape and dtype of its (first) result tensor."""
    kind: str
    nbytes: int
    group_size: int
    ranks: tuple
    shape: tuple = ()
    dtype: Optional[torch.dtype] = None


def _collective(kind: str, res, ranks: tuple) -> Collective:
    first = _tensors(res)[:1]
    shape, dtype = ((tuple(first[0].shape), first[0].dtype) if first
                    else ((), None))
    return Collective(kind, _nbytes(res), len(ranks), ranks, shape, dtype)


def _tensors(tree) -> list:
    out, seen = [], set()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storage(t: torch.Tensor):
    """The untyped storage of a plain strided tensor (a DTensor: of its
    local shard), else None (a wrapper subclass has no storage of its
    own)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t._local_tensor
    if t.layout != torch.strided or is_traceable_wrapper_subclass(t):
        return None
    return t.untyped_storage()


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
    """Tally one rank's matmul FLOPs, HBM bytes, collectives and live
    bytes over the ops dispatched while it is entered (see the module
    docstring); :meth:`summary` gives them under ``hlo_walk.walk``'s
    keys.  ``hold``: the step's arguments (a tree of tensors), held for
    the whole step; ``granule``: the allocation granule in bytes;
    ``trace``: keep one line per op."""

    def __init__(self, hold=None, granule: int = 1,
                 trace: bool = False) -> None:
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
        # live bytes: storage key -> (weak reference, rounded bytes)
        self.granule = int(granule)
        self._held: dict = {}
        self._own: dict = {}
        self.held_bytes = 0
        self.live_bytes = 0          # the step's own, dead ones not swept
        self.temp_peak_bytes = 0
        self.peak_index = None
        self.peak_op = None
        self.ops = 0
        self.trace = [] if trace else None
        for t in _tensors(hold):
            self._see(_storage(t), held=True)
        for m in tree_leaves(hold):
            if isinstance(m, torch.nn.Module):
                for t in (*m.parameters(), *m.buffers()):
                    self._see(_storage(t), held=True)

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
                self.collectives.append(_collective("all-to-all", out,
                                                    ranks))
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
        if _in_fake_mode(types):
            return out
        before = (self.matmul_flops, self.hbm_bytes)
        if not self._quiet:
            self._tally(func, args, kwargs, out)
        self._allocate(func, args, kwargs, out, before)
        return out

    # -- live bytes -------------------------------------------------------
    def _see(self, s, held: bool) -> None:
        """Count storage ``s`` (None: nothing) held or as the step's own,
        if the walk has not seen it; a known storage of the step's that
        an ``out=`` op resized is recounted."""
        if s is None:
            return
        key = s._cdata
        g = self.granule
        n = -(-s.nbytes() // g) * g
        own = self._own.get(key)
        if own is not None:
            if own[1] != n:
                self.live_bytes += n - own[1]
                self._own[key] = (own[0], n)
            return
        if key in self._held:
            return
        if held:
            self._held[key] = (StorageWeakRef(s), n)
            self.held_bytes += n
        else:
            self._own[key] = (StorageWeakRef(s), n)
            self.live_bytes += n

    def _sweep(self) -> None:
        expired = torch.UntypedStorage._expired
        dead = [k for k, (w, _) in self._own.items() if expired(w.cdata)]
        for k in dead:
            self.live_bytes -= self._own.pop(k)[1]

    def _allocate(self, func, args, kwargs, out, before) -> None:
        for t in _tensors((args, kwargs, out)):
            self._see(_storage(t), held=False)
        mark = self.temp_peak_bytes
        slack = 0 if mark < SWEEP_EXACT_BELOW else mark >> SWEEP_SLACK_SHIFT
        if self.live_bytes > mark + slack or self.trace is not None:
            self._sweep()
            if self.live_bytes > self.temp_peak_bytes:
                self.temp_peak_bytes = self.live_bytes
                self.peak_index, self.peak_op = self.ops, str(func)
        if self.trace is not None:
            def shapes(tree):
                return [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                        for t in _tensors(tree)]

            self.trace.append((str(func), shapes((args, kwargs)),
                               shapes(out),
                               self.matmul_flops - before[0],
                               self.hbm_bytes - before[1], self.live_bytes))
        self.ops += 1

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
            self.collectives.append(_collective(kind, res, ranks))
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

    @property
    def peak_bytes(self) -> int:
        """The step's high-water mark with what it holds."""
        return self.held_bytes + self.temp_peak_bytes

    def memory(self) -> dict:
        return {"granule": self.granule, "held_bytes": self.held_bytes,
                "temp_peak_bytes": self.temp_peak_bytes,
                "peak_bytes": self.peak_bytes, "peak_op": self.peak_op,
                "peak_index": self.peak_index, "ops": self.ops}

    def write_trace(self, path: str) -> None:
        """One line per op (``trace=True``): its index, the op, its
        operands' and results' local shapes and dtypes, its matmul FLOPs,
        HBM bytes and the step's own live bytes after it; the op at the
        high-water mark is marked ``<- peak``."""
        with open(path, "w") as f:
            f.write(f"# granule {self.granule} B; held {self.held_bytes} "
                    f"B; the step's own peak {self.temp_peak_bytes} B "
                    f"at op {self.peak_index}; peak with what it holds "
                    f"{self.peak_bytes} B\n"
                    "# index\top\toperands\tresults\tflops\thbm_bytes"
                    "\tlive_bytes\n")
            for i, (op, ins, outs, flops, hbm, live) in enumerate(
                    self.trace):
                mark = "\t<- peak" if i == self.peak_index else ""
                f.write(f"{i}\t{op}\t{ins}\t{outs}\t{flops}\t{hbm}\t"
                        f"{live}{mark}\n")

    def summary(self) -> dict:
        """``hlo_walk.walk``'s keys (``unresolved_trip_counts`` and
        ``num_computations`` have no eager meaning: ``None``), plus the
        FLOPs by dtype and by op, the collectives and the live bytes
        (:meth:`memory`)."""
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
            "memory": self.memory(),
        }


def walk(fn: Callable, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), summary)`` of one rank's work in the call,
    the arguments held."""
    with DispatchWalk(hold=(args, kwargs)) as w:
        out = fn(*args, **kwargs)
    return out, w.summary()
