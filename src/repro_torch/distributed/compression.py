"""Gradient compression hooks with error feedback (counterpart of
``repro.distributed.compression``).

For bandwidth-bound data-parallel training: compress gradients before the
optimizer sees them; the quantization error is fed back into the next step
(error feedback keeps SGD-style convergence guarantees — Karimireddy et al.
2019).  Two codecs, each over a tree of tensors:

* :func:`int8_compressor` — per-tensor symmetric int8 quantization (the
  dequantized gradient is what an all-reduce of the int8 codes carries).
* :func:`topk_compressor` — magnitude top-k sparsification (k as a
  fraction), the rest accumulates in the error buffer; ties with the k-th
  magnitude are kept, as in the reference.

``torch.round`` rounds half to even, as ``jnp.round``.  Both compose with
``make_train_step(compressor=...)``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.tree import leaves, unflatten


def _quant_dequant_int8(g: torch.Tensor) -> torch.Tensor:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _per_leaf(one, grads, err):
    pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, [p[0] for p in pairs]),
            unflatten(grads, [p[1] for p in pairs]))


@torch.no_grad()
def int8_compressor(grads, err):
    """Error-feedback int8: transmit quant(g + e), keep the residual."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        dq = _quant_dequant_int8(g32)
        return dq.to(g.dtype), g32 - dq

    return _per_leaf(one, grads, err)


@torch.no_grad()
def topk_compressor(grads, err, frac: float = 0.01):
    """Error-feedback magnitude top-k (per tensor)."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        flat = g32.reshape(-1)
        k = max(int(frac * flat.numel()), 1)
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        kept = torch.where(torch.abs(g32) >= thresh, g32, 0.0)
        return kept.to(g.dtype), g32 - kept

    return _per_leaf(one, grads, err)


def get_compressor(name: str):
    return {"none": None, "int8": int8_compressor,
            "topk": functools.partial(topk_compressor, frac=0.01)}[name]
