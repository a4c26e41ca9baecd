"""Atomic, restart-safe checkpointing (counterpart of
``repro.train.checkpoint``).

Layout:  <dir>/step_<N>/
    manifest.json   — step, scalar leaves, the caller's ``extra`` (e.g. the
                      data pipeline's position) and the array keys; the
                      reference's ``manifest.msgpack`` with the same fields
    arrays.npz      — one array a leaf, keyed by its path
                      (``params/layers/attn/wq``, ``opt/mu/...``,
                      ``opt/step``, ``step``)
    COMMIT          — written last; a checkpoint without COMMIT is ignored
                      (atomic-commit protocol: written under
                      ``step_<N>.tmp``, then renamed)

Restoring reads only ``arrays.npz`` and ``COMMIT``, as the reference's
does, so a checkpoint written by either package restores in the other.

Sharded state (DTensor leaves, ``launch/steps.py``): ``save`` gathers each
DTensor leaf to its full array on every rank (a collective: every rank of
the mesh calls ``save``), rank 0 of the process group writes, and every
rank waits for the commit.  ``restore(..., shardings=)`` places each array
on the *current* mesh with ``distribute_tensor`` (each rank keeps its own
block), whatever mesh wrote it: this is where elastic resharding happens.
Without ``shardings`` every array goes to one device (``device=``).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves_with_paths, unflatten


def _flatten_with_paths(tree) -> dict:
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in leaves_with_paths(tree)}


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _ranks() -> tuple[int, bool]:
    """(this process's rank, whether a process group is running)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), True
    return 0, False


def save(directory: str, step: int, state, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Write an atomic checkpoint; prune old ones to ``keep``.  With
    DTensor leaves every rank calls it and rank 0 writes."""
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")

    leaves = _flatten_with_paths(state)
    arrays = {k: _numpy(v) for k, v in leaves.items() if hasattr(v, "shape")}
    scalars = {k: v for k, v in leaves.items() if not hasattr(v, "shape")}
    rank, group = _ranks()
    sharded = group and any(isinstance(v, DTensor) for v in leaves.values())
    if sharded and rank != 0:
        import torch.distributed as dist

        dist.barrier()                      # rank 0 has committed
        return final
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": int(step),
        "scalars": {k: (v if isinstance(v, (int, float, str, bool)) else None)
                    for k, v in scalars.items()},
        "extra": extra or {},
        "keys": sorted(arrays.keys()),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    steps = sorted(all_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
    if sharded:
        import torch.distributed as dist

        dist.barrier()
    return final


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMIT")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like, device=None, shardings=None):
    """Restore into the structure of ``like`` (a tree template).

    ``shardings`` (a tree of ``distributed.sharding.NamedSharding`` of
    ``like``'s structure; a None subtree places nothing) puts each array
    on the current mesh as a DTensor of its layout.  Every other saved
    array becomes a tensor of its saved dtype on ``device``, or, when
    ``device`` is None, on the device of the template leaf it replaces
    (the CPU for a template leaf that is no tensor).  A template leaf with
    no saved array (e.g. a newly added state field) is kept."""
    path = os.path.join(directory, f"step_{step}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"checkpoint {path} not committed")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    layouts = {} if shardings is None else _flatten_with_paths(shardings)

    new_leaves = []
    for key, template in _flatten_with_paths(like).items():
        if key not in arrays:
            new_leaves.append(template)
            continue
        layout = layouts.get(key)
        if layout is not None:
            from repro_torch.distributed.sharding import distribute

            whole = torch.from_numpy(arrays[key]).to(
                layout.mesh.device_type)
            new_leaves.append(distribute(whole, layout))
            continue
        dev = device
        if dev is None:
            dev = (template.device if isinstance(template, torch.Tensor)
                   else "cpu")
        new_leaves.append(torch.from_numpy(arrays[key]).to(dev))
    return unflatten(like, new_leaves)


def restore_extra(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)["extra"]
