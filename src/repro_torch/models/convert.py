"""Weights carried across from the JAX package, and between the port's
serving module and its training tree.

The reference's parameter tree is nested dicts with layer leaves stacked
on a leading ``(L, ...)`` axis (``jax.tree.map(np.asarray, params)``).
The port's trainer holds the same tree as float32 tensors
(``tree_from_reference``, ``tree_from_module``); ``load_reference_params``
fills a serving module from either form."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.transformer import _tree
from repro_torch.tree import tree_map


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + ".")
        elif isinstance(v, torch.Tensor):
            yield name, v
        else:
            yield name, np.asarray(v)


@torch.no_grad()
def load_reference_params(model: nn.Module, params: dict) -> None:
    """Fill ``model``'s parameters from the reference's tree (numpy arrays,
    or tensors on any device, e.g. a trained state's ``params``), slicing
    the layer axis of ``layers.*`` leaves.  Every name and shape is
    checked; raises ``ValueError`` on a leaf the model has no parameter
    for, a shape that differs, or a parameter no leaf fills."""
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
            if tuple(p.shape) != tuple(a.shape):
                raise ValueError(f"{target}: shape {tuple(p.shape)} in the "
                                 f"model, {tuple(a.shape)} in the reference")
            p.copy_(torch.as_tensor(a))
            filled.add(target)
    missing = sorted(set(own) - filled)
    if missing:
        raise ValueError(f"no reference leaf fills {missing}")


def tree_from_reference(params: dict, device) -> dict:
    """The reference's numpy tree as float32 tensors on ``device``, same
    nesting and stacked layout."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                           device=device), params)


@torch.no_grad()
def tree_from_module(model: nn.Module) -> dict:
    """A module's parameters as the reference's tree: copies on the
    module's device, the layers' leaves stacked on ``(L, ...)``."""
    tree = _tree(model, torch.float32)          # detached, not copied
    layers = tree.pop("layers")
    tree = tree_map(torch.clone, tree)
    tree["layers"] = tree_map(lambda *xs: torch.stack(xs),
                              *[layers[str(i)] for i in range(len(layers))])
    return tree
