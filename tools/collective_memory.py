"""Device memory of one DTensor reduce-scatter on gloo ranks that share a
card, against what the dispatch walk counts for the same call.

``chip_smoke.py``'s ``[shard]`` runs its (data 2, model 2) mesh as four
gloo ranks on one card, and ``[dryrun]`` holds the walk's ``temp_bytes``
(``roofline/dispatch_walk.py``: the storages the dispatched ops bring in)
to each rank's measured high-water mark.  A process group backend's own
allocations inside a collective are no dispatched op.  This script runs
the collective at ``[shard]``'s step's high-water mark: the tied
embedding's gradient, (49,152, 288) float32 a rank, a partial sum over
the model axis, reduce-scattered to its (24,576, 288) vocab shard.  Each
rank prints its input and output bytes, the walk's own bytes for the
call, and ``max_memory_allocated`` above what was allocated before it.

Usage (one card, four ranks)::

    python tools/collective_memory.py
    python tools/collective_memory.py --device cpu   # the walk alone
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

SHAPE = (49152, 288)
MESH = (2, 2)


def rank_main(rank: int, ranks: int, init_file: str, device: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.dispatch_walk import (
        CUDA_ALLOC_GRANULE, DispatchWalk)

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_debug_mesh(*MESH, device_type=device)
        local = torch.ones(SHAPE, dtype=torch.float32, device=device)
        grad = DTensor.from_local(local, mesh, (Shard(1), Partial()),
                                  run_check=False)
        target = (Shard(1), Shard(0))
        out = grad.redistribute(mesh, target).to_local()  # warm-up
        del out
        before = after = None
        if device == "cuda":
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with DispatchWalk(hold=local, granule=CUDA_ALLOC_GRANULE) as w:
            out = grad.redistribute(mesh, target).to_local() + 0
        if device == "cuda":
            torch.cuda.synchronize()
            after = torch.cuda.max_memory_allocated() - before
        mib = 2 ** 20
        print(f"rank {rank}: input {local.numel() * 4 / mib:.1f} MiB, "
              f"output {out.numel() * 4 / mib:.1f} MiB; the walk's own "
              f"bytes {w.temp_peak_bytes / mib:.1f} MiB at "
              f"{w.peak_op}; measured "
              + ("not measured (no card)" if after is None else
                 f"{after / mib:.1f} MiB ({after} B) above the "
                 f"{before} B allocated before")
              + (f" on {torch.cuda.get_device_name(0)}"
                 if device == "cuda" else ""), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu for the walk alone",
              file=sys.stderr)
        return 2
    ranks = MESH[0] * MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(rank_main, args=(ranks, os.path.join(tmp, "pg"),
                                            args.device),
                           nprocs=ranks, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
