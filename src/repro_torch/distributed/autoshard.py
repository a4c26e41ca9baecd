"""Activation sharding constraints for model code (MaxText-style;
counterpart of ``repro.distributed.autoshard``).

Without explicit constraints a sharding propagator may resolve
FSDP-sharded weights against batch-sharded activations by *replicating the
batch* (all-gathering activations instead of weights): compute then scales
with the model axis only and the data axis does redundant work (the
reference measured a 16x matmul-FLOP inflation on its 16x16 mesh).

Models call :func:`constrain` at residual-stream boundaries.  Inside a
:func:`sharding_scope` it redistributes a DTensor to the kind's placements
(``DTensor.redistribute``); a plain tensor there is a fault and raises.
Outside a scope it returns its argument itself and runs no operator, so
single-device models and the engine are unaffected.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from repro_torch.distributed.sharding import axis_sizes, batch_spec, named

_TLS = threading.local()


@contextlib.contextmanager
def sharding_scope(mesh, batch_axes: tuple = ("pod", "data"),
                   model_axis: str = "model"):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = {"mesh": mesh, "batch_axes": batch_axes,
                "model_axis": model_axis}
    try:
        yield
    finally:
        _TLS.ctx = prev


def _ctx() -> Optional[dict]:
    return getattr(_TLS, "ctx", None)


def data_group_count(tokens: int) -> int:
    """Number of dispatch groups for grouped (data-axis-local) MoE routing.

    Inside a sharding scope this is the product of the batch axes other
    than the model axis (each shard routes its own tokens), halved until it
    divides ``tokens``; outside, 1."""
    ctx = _ctx()
    if ctx is None:
        return 1
    sizes = axis_sizes(ctx["mesh"])
    g = 1
    for a in ctx["batch_axes"]:
        if a != ctx["model_axis"] and a in sizes:
            g *= sizes[a]
    while g > 1 and tokens % g != 0:
        g //= 2
    return max(g, 1)


def constraint_spec(shape, kind: str, sizes: dict, batch_axes: tuple,
                    model_axis: str = "model") -> tuple:
    """The spec of a named constraint for a tensor of ``shape``.

    kinds:
      "btd"  — (B, S, D) residual stream: batch over data(/pod)
      "btv"  — (B, S, V) logits: batch over data, vocab over model
      "bd"   — (B, D): batch over data
      "ecd"  — (E, C, D) MoE expert buffer: experts over model if divisible
      "gecd" — (G, E, C, D) grouped MoE buffer: groups over data, experts
               over model when the count divides
    """
    b_ax = batch_spec(sizes, batch_axes, shape[0])
    msize = sizes.get(model_axis, 1)
    if kind in ("btd", "bd"):
        return (b_ax,)
    if kind == "btv":
        return (b_ax, None, model_axis if shape[-1] % msize == 0 else None)
    if kind == "ecd":
        return (model_axis if shape[0] % msize == 0 else None,)
    if kind == "gecd":
        e_ok = shape[1] % msize == 0 and shape[1] >= msize
        return (b_ax, model_axis if e_ok else None)
    raise ValueError(kind)


def constrain(x, kind: str):
    """Redistribute DTensor ``x`` to the named constraint's placements if
    inside a sharding scope; outside one, ``x`` itself."""
    ctx = _ctx()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"constrain({kind!r}) inside a sharding scope got a "
                        f"plain {type(x).__name__}: the step's inputs must "
                        f"be DTensors on the scope's mesh")
    mesh = ctx["mesh"]
    spec = constraint_spec(tuple(x.shape), kind, axis_sizes(mesh),
                           ctx["batch_axes"], ctx["model_axis"])
    want = list(named(mesh, spec).placements)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
