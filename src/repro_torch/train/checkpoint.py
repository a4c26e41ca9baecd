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
The reference's ``shardings=`` argument (placing arrays on a new mesh)
waits for the port's ``distributed/sharding.py``; ``restore`` puts every
array on one device.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, unflatten


def _flatten_with_paths(tree) -> dict:
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in leaves_with_paths(tree)}


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, state, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    """Write an atomic checkpoint; prune old ones to ``keep``."""
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)

    leaves = _flatten_with_paths(state)
    arrays = {k: _numpy(v) for k, v in leaves.items() if hasattr(v, "shape")}
    scalars = {k: v for k, v in leaves.items() if not hasattr(v, "shape")}
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


def restore(directory: str, step: int, like, device=None):
    """Restore into the structure of ``like`` (a tree template).

    Each saved array becomes a tensor of its saved dtype on ``device``, or,
    when ``device`` is None, on the device of the template leaf it replaces
    (the CPU for a template leaf that is no tensor).  A template leaf with
    no saved array (e.g. a newly added state field) is kept."""
    path = os.path.join(directory, f"step_{step}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"checkpoint {path} not committed")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    new_leaves = []
    for key, template in _flatten_with_paths(like).items():
        if key not in arrays:
            new_leaves.append(template)
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
