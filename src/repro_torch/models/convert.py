"""Weights carried across from the JAX package: the reference's parameter
tree (nested dicts of numpy arrays, ``jax.tree.map(np.asarray, params)``,
layer leaves stacked on a leading ``(L, ...)`` axis) into a port module."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + ".")
        else:
            yield name, np.asarray(v)


@torch.no_grad()
def load_reference_params(model: nn.Module, params: dict) -> None:
    """Fill ``model``'s parameters from the reference's tree, slicing the
    layer axis of ``layers.*`` leaves.  Every name and shape is checked;
    raises ``ValueError`` on a leaf the model has no parameter for, a shape
    that differs, or a parameter no leaf fills."""
    own = dict(model.named_parameters())
    filled = set()
    for name, arr in _leaves(params):
        if name.startswith("layers."):
            rest = name[len("layers."):]
            targets = [(f"layers.{i}.{rest}", arr[i])
                       for i in range(arr.shape[0])]
            if arr.shape[0] != len(getattr(model, "layers", ())):
                raise ValueError(f"{name}: {arr.shape[0]} stacked layers, "
                                 f"the model has {len(model.layers)}")
        else:
            targets = [(name, arr)]
        for target, a in targets:
            p = own.get(target)
            if p is None:
                raise ValueError(f"reference leaf {name!r} has no parameter "
                                 f"{target!r} in the model")
            if tuple(p.shape) != a.shape:
                raise ValueError(f"{target}: shape {tuple(p.shape)} in the "
                                 f"model, {a.shape} in the reference")
            p.copy_(torch.tensor(a, dtype=p.dtype))
            filled.add(target)
    missing = sorted(set(own) - filled)
    if missing:
        raise ValueError(f"no reference leaf fills {missing}")
