"""Weights carried across from the JAX package, and between the port's
serving modules and their training trees.

The reference's parameter tree is nested dicts; the leaves of ``layers``,
``enc_layers`` and ``dec_layers`` are stacked on a leading ``(L, ...)``
axis, ``blocks`` (xLSTM) is a tuple of per-layer dicts, and everything
else (``site_proj``, ``shared.*``, ``dec_pos`` ...) is a plain leaf
(``jax.tree.map(np.asarray, params)``).  The port's trainer holds the same
tree as float32 tensors (``tree_from_reference``, ``tree_from_module``);
``load_reference_params`` fills a serving module from either form.  Each
refuses a leaf the model has no parameter for, a shape that differs, or a
parameter no leaf fills.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.module import module_tree
from repro_torch.tree import leaves_with_paths, tree_map

STACKED = ("layers", "enc_layers", "dec_layers")


def _leaves(tree, prefix: str = ""):
    """``(dotted name, array)`` of every leaf of a reference tree."""
    for path, v in leaves_with_paths(tree):
        name = prefix + ".".join(map(str, path))
        yield name, v if isinstance(v, torch.Tensor) else np.asarray(v)


def _targets(model: nn.Module, name: str, arr):
    """The model's parameter names and the slices of ``arr`` that fill
    them: a stacked leaf fills one parameter a layer."""
    top, _, rest = name.partition(".")
    if top not in STACKED:
        return [(name, arr)]
    count = len(getattr(model, top, ()))
    if arr.shape[0] != count:
        raise ValueError(f"{name}: {arr.shape[0]} stacked layers, the model "
                         f"has {count}")
    return [(f"{top}.{i}.{rest}", arr[i]) for i in range(count)]


def check_reference_tree(model: nn.Module, params) -> None:
    """Raise ``ValueError`` unless ``params`` is ``model``'s tree in the
    reference's layout: every leaf a parameter of the same shape (a
    stacked leaf one a layer), every parameter filled."""
    own = {n: tuple(p.shape) for n, p in model.named_parameters()}
    filled = set()
    for name, arr in _leaves(params):
        for target, a in _targets(model, name, arr):
            if target not in own:
                raise ValueError(f"reference leaf {name!r} has no parameter "
                                 f"{target!r} in the model")
            if own[target] != tuple(a.shape):
                raise ValueError(f"{target}: shape {own[target]} in the "
                                 f"model, {tuple(a.shape)} in the reference")
            filled.add(target)
    missing = sorted(set(own) - filled)
    if missing:
        raise ValueError(f"no reference leaf fills {missing}")


@torch.no_grad()
def load_reference_params(model: nn.Module, params) -> None:
    """Fill ``model``'s parameters from the reference's tree (numpy arrays,
    or tensors on any device, e.g. a trained state's ``params``), slicing
    the layer axis of stacked leaves; ``check_reference_tree`` first."""
    check_reference_tree(model, params)
    own = dict(model.named_parameters())
    for name, arr in _leaves(params):
        for target, a in _targets(model, name, arr):
            own[target].copy_(torch.as_tensor(a))


def tree_from_reference(params, device, model: nn.Module = None):
    """The reference's numpy tree as float32 tensors on ``device``, same
    nesting and layout; checked against ``model``'s layout when given."""
    if model is not None:
        check_reference_tree(model, params)
    return tree_map(lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                           device=device), params)


@torch.no_grad()
def tree_from_module(model: nn.Module) -> dict:
    """A module's parameters as the reference's tree: copies on the
    module's device, the stacked lists' leaves stacked on ``(L, ...)``,
    ``blocks`` a tuple."""
    tree = module_tree(model, torch.float32)     # detached, not copied
    for name, sub in tree.items():
        if name in STACKED:
            tree[name] = tree_map(lambda *xs: torch.stack(xs), *sub)
        elif isinstance(sub, list):
            tree[name] = tuple(tree_map(torch.clone, b) for b in sub)
        else:
            tree[name] = tree_map(torch.clone, sub)
    return tree
