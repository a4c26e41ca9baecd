"""Multi-pod dry run: build every (architecture × shape) cell on the
production mesh of a fake process group and record memory, FLOP, byte and
collective evidence of one rank's step (counterpart of
``repro.launch.dryrun``).

The reference forces 512 virtual XLA host devices, lowers and compiles
each cell and reads XLA's memory analysis and the compiled HLO.  Torch
has no such compile; here a cell runs once, abstractly:

* ``main`` starts a *fake* process group (``torch.distributed``'s
  ``"fake"`` backend: one process plays rank 0 of 256 or 512 ranks and
  every collective returns at once, its data unchanged) and builds the
  16×16 or 2×16×16 production mesh on it.  Importing this module starts
  nothing.
* An LM cell is built by ``launch/steps.py::build_cell``, its arguments
  made abstract by ``materialize(cell, "meta")`` (meta DTensors, no
  memory, no host array of the global batch), and its step run once
  through ``run_cell`` under ``roofline.dispatch_walk.DispatchWalk``:
  rank 0's matmul FLOPs, HBM bytes and collectives, priced by
  ``roofline.analysis.analyze_step``.  The LM cells run on the meta
  device over a CPU-typed mesh whatever ``--device`` says, as the
  reference lowers abstractly.
* The OLA verify cell's round reads values back (``.item()`` in
  ``core/engine.py``), so it cannot run on meta: it runs one round on
  rank 0's real local shard, on ``--device`` (the card unless ``--device
  cpu``; it raises without one, as every entry point of the port).  The
  fake group's reductions leave the data unchanged, so its record holds
  counts and shapes, never estimates.  The replicated layout's store is
  25.8 GB a rank: its round runs at ``REPLICATED_ROUND_CHUNKS`` chunks
  (named in the record's ``reduced`` field), its memory is its layout's.

Each record has the reference's keys.  ``lower_s`` and ``compile_s`` are
the build seconds and the traced step's seconds.  ``memory.argument_bytes``
is rank 0's local bytes summed from the arguments' layouts (exact);
``memory.output_bytes`` the local bytes of the step's outputs and
``memory.alias_bytes`` those of them that live in an argument's storage
(the donated train state).  The rest
comes from the walk (``roofline/dispatch_walk.py``), with each storage
rounded to the CUDA caching allocator's 512-byte granule:

* ``memory.temp_bytes``: the step's own high-water mark of live bytes
  above what it holds (its arguments);
* ``memory.peak_bytes``: ``argument_bytes + temp_bytes``;
* ``flops``: the walk's matmul FLOPs; ``bytes_accessed``: its HBM bytes.

They differ from XLA's in kind.  XLA's ``temp_size_in_bytes`` leaves out
the outputs, and with ``donate_argnums`` (the reference's train step)
its outputs reuse the argument buffers.  The port's train step is
donated too (``train/train_step.py``: the new state is written into the
old one's storages), so its outputs alias its arguments and
``memory.alias_bytes`` counts them, as XLA's ``alias_size_in_bytes``
does; ``temp_bytes`` holds at least the outputs that alias no argument,
and at the optimizer only the gradients and one leaf's temporaries are
live beside the state.  XLA's ``flops``
counts elementwise ops too; ``flops`` here counts matmuls alone.  The
OLA verify cell's round runs at the cut size (``reduced``): its record
gives the full layout's ``argument_bytes`` plus the cut round's
``temp_bytes``.  ``--save-trace`` writes the walk's op list next to the
record (``<tag>.trace.txt``: one line per op with its shapes, FLOPs, HBM
bytes and the live bytes after it, the high-water mark's op marked),
as the reference's ``--save-hlo`` writes its compiled HLO.  Added:
``memory.state_bytes_by_rank`` (the step's first argument, each rank's
local bytes in rank order, as runs ``[bytes, ranks]``),
``collective_counts`` by kind, ``kv_cache_gather_bytes`` and ``device``.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all --multi-pod both --out results/dryrun
    python -m repro_torch.launch.dryrun --verify-cell sharded --device cpu
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \\
        --save-trace
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.roofline.dispatch_walk import CUDA_ALLOC_GRANULE, DispatchWalk

# the replicated verify layout's round runs at this many chunks (the
# whole store is 25.8 GB a rank)
REPLICATED_ROUND_CHUNKS = 256


def start_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, as rank 0.
    Importing ``fake_pg`` registers the ``"fake"`` backend (torch 2.11
    has it only so; 2.13 also registers it itself) and gives its store."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


@contextlib.contextmanager
def fake_group(world: int):
    """:func:`start_fake_group`, destroyed on exit."""
    import torch.distributed as dist

    start_fake_group(world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Local bytes from layouts
# ---------------------------------------------------------------------------

def local_shape(shape: tuple, sharding, coord: tuple) -> tuple:
    """The block of a ``shape`` tensor laid out by ``sharding`` that the
    rank at mesh coordinate ``coord`` holds (DTensor's split: each mesh
    dim in order cuts its tensor dim into ``ceil(n/k)`` blocks)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    if sharding is None:
        return tuple(out)
    sizes = tuple(sharding.mesh.shape)
    for md, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            n, k, i = out[p.dim], sizes[md], coord[md]
            block = -(-n // k)
            out[p.dim] = max(0, min(n, (i + 1) * block) - min(n, i * block))
    return tuple(out)


def arg_bytes(tree, coord: tuple) -> int:
    """Local bytes at mesh coordinate ``coord`` of the ``ArgSpec`` leaves
    of ``tree``."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch.steps import ArgSpec

    total = 0
    for a in tree_leaves(tree):
        if isinstance(a, ArgSpec):
            n = 1
            for d in local_shape(a.shape, a.sharding, coord):
                n *= d
            total += n * torch.empty((), dtype=a.dtype).element_size()
    return total


def rank_coords(mesh) -> list:
    """Each rank's mesh coordinate, in rank order."""
    ranks = mesh.mesh.numpy()
    return [tuple(int(c) for c in np.argwhere(ranks == r)[0])
            for r in range(ranks.size)]


def state_bytes_by_rank(tree, mesh) -> list:
    """Local bytes of ``tree``'s ``ArgSpec`` leaves on each rank, in rank
    order, as runs ``[[bytes, ranks], ...]``."""
    runs = []
    for c in rank_coords(mesh):
        n = arg_bytes(tree, c)
        if runs and runs[-1][0] == n:
            runs[-1][1] += 1
        else:
            runs.append([n, 1])
    return runs


def _locals(tree) -> list:
    """The local tensors of ``tree``'s tensor leaves (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _locals(tree))


def _alias_bytes(out, args) -> int:
    """The local bytes of ``out``'s leaves that live in a storage of
    ``args`` (XLA's ``alias_size_in_bytes``: the donated train state)."""
    held = {t.untyped_storage()._cdata for t in _locals(args)}
    return sum(t.numel() * t.element_size() for t in _locals(out)
               if t.untyped_storage()._cdata in held)


def _collective_counts(walk: dict) -> dict:
    return dict(collections.Counter(c.kind for c in walk["collectives"]))


def kv_cache_gather_bytes(collectives, head_dim: int) -> int:
    """The result bytes of the all-gathers that move blocks of a KV cache
    (B, T, H, D) in a decode step: floating results of 4 dims whose last
    is ``head_dim`` and whose second holds more than one slot (a step's
    own query, key and value hold one)."""
    return sum(c.nbytes for c in collectives
               if c.kind == "all-gather" and len(c.shape) == 4
               and c.shape[-1] == head_dim and c.shape[1] > 1
               and c.dtype is not None and c.dtype.is_floating_point)


def _mesh_dict(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _memory(walk, argument_bytes: int, out, args) -> dict:
    """The record's ``memory`` from the walk's live bytes: the step's own
    high-water mark over ``argument_bytes``; the outputs' local bytes and
    those of them that alias an argument."""
    temp = walk.temp_peak_bytes
    return {"argument_bytes": argument_bytes,
            "output_bytes": _local_bytes(out),
            "alias_bytes": _alias_bytes(out, args),
            "temp_bytes": temp, "peak_bytes": argument_bytes + temp}


def _write(record: dict, out_dir: Optional[str], tag: str,
           walk=None) -> None:
    print(json.dumps(record))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
        if walk is not None and walk.trace is not None:
            walk.write_trace(os.path.join(out_dir, tag + ".trace.txt"))


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape, multi_pod: bool = False,
             out_dir: Optional[str] = None, save_trace: bool = False, *,
             mesh=None, reduced: bool = False,
             overrides: Optional[dict] = None) -> dict:
    """The record of ``arch`` at ``shape`` (a name of ``SHAPES`` or a
    ``ShapeSpec``) on the production mesh of the current (fake) process
    group, or on ``mesh``; ``reduced`` and ``overrides`` as
    ``build_cell``'s.  ``save_trace`` writes the walk's op list next to
    the record in ``out_dir``.  A decode record adds
    ``kv_cache_gather_bytes`` (:func:`kv_cache_gather_bytes`; None for
    other cells)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell, materialize
    from repro_torch.launch.steps import run_cell as run_step
    from repro_torch.roofline.analysis import analyze_step

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, unroll_for_cost=False,
                      reduced=reduced, overrides=overrides)
    args, _ = materialize(cell, "meta")
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    with DispatchWalk(hold=args, granule=CUDA_ALLOC_GRANULE,
                      trace=save_trace) as w:
        out = run_step(cell, *args)
    t_step = time.perf_counter() - t0
    walk = w.summary()

    me = tuple(mesh.get_coordinate())
    n_chips = mesh.size()
    record = {
        "arch": arch, "shape": cell.shape,
        "mesh": _mesh_dict(mesh),
        "chips": n_chips,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_step, 2),
        "memory": dict(
            _memory(w, arg_bytes(cell.args, me), out, args),
            state_bytes_by_rank=state_bytes_by_rank(cell.args[0], mesh)),
        "flops": w.matmul_flops,
        "bytes_accessed": w.hbm_bytes,
        "collective_counts": _collective_counts(walk),
        "kv_cache_gather_bytes": (
            kv_cache_gather_bytes(walk["collectives"], cell.cfg.head_dim_)
            if cell.spec.kind == "decode" else None),
        "device": "meta",
    }
    record.update(analyze_step(walk, arch, cell.spec, n_chips,
                               cfg=get_config(arch, reduced=reduced)))
    tag = f"{arch}__{cell.shape}__{'multipod' if multi_pod else 'pod'}"
    _write(record, out_dir, tag, w)
    return record


def _local_store(program, shape: tuple, device, seed: int = 0):
    """``shape`` = (chunks, tuples, record bytes) of ASCII records: one
    chunk of uniform values in [0, 100) encoded, then copied to every
    chunk of the rank's block."""
    n, m, _ = shape
    rng = np.random.default_rng(seed)
    values = 100.0 * rng.random((m, program.codec.num_cols))
    one = torch.from_numpy(program.codec.encode(values)).to(device)
    return one.expand((n,) + tuple(one.shape)).contiguous()


def run_verify_cell(layout: str, multi_pod: bool = False,
                    out_dir: Optional[str] = None, save_trace: bool = False,
                    *, device=None, mesh=None,
                    cut: Optional[dict] = None) -> dict:
    """The record of the OLA verify cell's round in ``layout`` on this
    process's rank of the production mesh (or ``mesh``): memory from the
    production program's layouts, one round on the rank's real block on
    ``device`` (CUDA unless named) under the walk.  ``cut`` (``n_chunks``,
    ``m_per_chunk`` of ``production_verify_program``) shrinks the round's
    store; the replicated layout's defaults to ``REPLICATED_ROUND_CHUNKS``
    chunks.  ``save_trace`` as :func:`run_cell`'s."""
    from repro_torch.core.engine_spmd import mesh_group
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.verify_cell import (
        build_verify_cell, local_state, production_verify_program)
    from repro_torch.roofline.analysis import analyze_step

    dev = resolve_device(device)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    if cut is None and layout == "replicated":
        cut = {"n_chunks": REPLICATED_ROUND_CHUNKS}
    _, rank, n_dev = mesh_group(mesh)
    me = tuple(mesh.get_coordinate())
    t0 = time.perf_counter()
    _, full_args, _ = build_verify_cell(mesh, layout, device=dev)
    program = None
    if cut:
        program = production_verify_program(workers=n_dev, device=dev,
                                            **cut)[0]
    step, args, program = build_verify_cell(mesh, layout, program=program,
                                            device=dev)
    packed = _local_store(program, local_shape(args[1].shape,
                                               args[1].sharding, me), dev)
    speeds = torch.ones(local_shape(args[2].shape, args[2].sharding, me),
                        device=dev)
    state = local_state(program, rank, program.config.num_workers // n_dev)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    with DispatchWalk(hold=(state, packed, speeds),
                      granule=CUDA_ALLOC_GRANULE, trace=save_trace) as w:
        out = step(state, packed, speeds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    walk = w.summary()
    n_chips = mesh.size()
    record = {
        "arch": f"ola-verify-{layout}", "shape": "verify_round",
        "mesh": _mesh_dict(mesh), "chips": n_chips,
        "lower_s": round(t_build, 2), "compile_s": round(t_round, 2),
        "memory": dict(
            _memory(w, arg_bytes(full_args, me), out,
                    (state, packed, speeds)),
            state_bytes_by_rank=state_bytes_by_rank(full_args[0], mesh)),
        "flops": w.matmul_flops,
        "bytes_accessed": w.hbm_bytes,
        "collective_counts": _collective_counts(walk),
        "device": dev.type,
        "reduced": cut or None,
    }
    record.update(analyze_step(walk, "smollm-135m", "train_4k", n_chips))
    # model_flops is an LM concept; null it out for the engine cell
    record["roofline"]["model_flops"] = None
    record["roofline"]["useful_flops_ratio"] = None
    record["roofline"]["roofline_fraction"] = None
    _write(record, out_dir,
           f"ola-verify-{layout}__{'multipod' if multi_pod else 'pod'}", w)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--verify-cell", choices=("replicated", "sharded"),
                    default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"), default="no")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--save-trace", action="store_true",
                    help="write the walk's op list next to each record")
    ap.add_argument("--device", default=None,
                    help="the verify cell's device (CUDA unless named); the "
                         "LM cells run on meta")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import cells

    pods = {"no": [False], "yes": [True], "both": [False, True]}[
        args.multi_pod]
    if args.verify_cell:
        for mp in pods:
            with fake_group(512 if mp else 256):
                run_verify_cell(args.verify_cell, mp, args.out,
                                args.save_trace, device=args.device)
        return

    if args.all:
        todo = [(a, s) for a, s, skipped in cells() if not skipped]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    failures = []
    for mp in pods:
        with fake_group(512 if mp else 256):
            for arch, shape in todo:
                try:
                    run_cell(arch, shape, mp, args.out, args.save_trace)
                except Exception as e:  # noqa: BLE001 — report, continue sweep
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
    if failures:
        print("FAILURES:", json.dumps(failures, indent=1))
        raise SystemExit(1)
    print("DRYRUN OK:", len(todo) * len(pods), "cells")


if __name__ == "__main__":
    main()
