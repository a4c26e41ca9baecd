"""Shared layers: norms, RoPE and M-RoPE, sinusoidal positions,
dense/embedding parameters, MLPs (counterpart of ``repro.models.layers``).

Plain PyTorch ops written in the reference's order, including where the
dtype changes: a norm computes in float32, casts to the compute dtype, then
multiplies by its weight cast to the compute dtype; RoPE rotates in float32
and casts back.  Weights are float32 and are cast to the activation's dtype
at use, as in the reference (a no-op for a weight already held in that
dtype).  Parameter dicts use the reference's leaf names and layouts.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed import layout


def pad_to(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------

def truncated_normal_(t: torch.Tensor, generator: torch.Generator,
                      lo: float = -2.0, hi: float = 2.0) -> torch.Tensor:
    """Fill float32 ``t`` in place with a standard normal truncated to
    [lo, hi] (inverse CDF of a uniform draw between the bounds' CDFs, the
    reference's ``jax.random.truncated_normal`` method) from ``generator``,
    on ``t``'s device."""
    a = math.erf(lo / math.sqrt(2.0))
    b = math.erf(hi / math.sqrt(2.0))
    t.uniform_(a, b, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0))
    return t.clamp_(lo, hi)


def dense_init_(t: torch.Tensor, generator: torch.Generator,
                scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal dense parameter with fan-in scaling
    (``1/sqrt(shape[0])`` unless ``scale`` is given), as ``dense_init``."""
    fan_in = t.shape[0] if t.dim() >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return truncated_normal_(t, generator).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * weight.to(dt) + bias.to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated pairwise by float32 angles (..., S, D/2),
    in float32, cast back to x's dtype."""
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, D); positions (..., S) -> rotated x.

    Interleaved-pair convention (llama), computed in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, sections: tuple,
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the head dim's frequency slots are split
    into (t, h, w) sections, each rotated by its own position stream.

    x (..., S, H, D); positions3 (3, ..., S); ``sections`` are half-dim
    sizes summing to D/2 (e.g. (16, 24, 24) for D = 128)."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {d // 2}")
    freqs = rope_freqs(d, theta, x.device)                      # (D/2,)
    sec_id = torch.as_tensor(np.concatenate(
        [np.full(s, i) for i, s in enumerate(sections)]), device=x.device)
    # slot k rotates by positions3[sec_id[k]]
    pos = positions3.index_select(0, sec_id).movedim(0, -1)     # (..., S, D/2)
    return _rotate(x, pos.to(torch.float32) * freqs)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, D): computed in numpy
    float64 as the reference does, then cast to float32."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.as_tensor(out.astype(np.float32), device=device)


# ---------------------------------------------------------------------------
# Contractions and MLPs
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,d...->...", x, w)``: contract x's last dim with w's
    first (w of shape (d, *out)), w cast to x's dtype."""
    if isinstance(w, DTensor):
        return layout.contract(x, w.to(x.dtype), 1)
    out = torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1))
    return out.reshape(x.shape[:-1] + w.shape[1:])


def swiglu_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, p["gate"])
    u = linear(x, p["up"])
    h = F.silu(g) * u
    return linear(h, p["down"])


def gelu_mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = linear(x, p["fc1"]) + p["b1"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return linear(h, p["fc2"]) + p["b2"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_apply(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table (a DTensor table through
    ``layout.embedding``: its vocab gathered, then ``F.embedding``)."""
    table = p["embedding"]
    if isinstance(table, DTensor):
        return layout.embedding(table, tokens)
    return table[tokens.long()]


def unembed_apply(p: dict, x: torch.Tensor, tied: bool = True) -> torch.Tensor:
    """``x @ w.T`` of the (V, d) table; a DTensor table through
    ``layout.contract`` (each rank's own rows by its own vocab columns:
    the weight gathered over the batch's mesh dims, never the rows)."""
    w = p["embedding"] if tied else p["unembed"]
    if isinstance(w, DTensor):
        return layout.contract(x, w.to(x.dtype).t(), 1)
    return torch.matmul(x, w.to(x.dtype).t())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_real: int, ignore_id: int = -100) -> torch.Tensor:
    """Mean next-token CE over valid positions; padded vocab columns
    masked.  DTensor logits take the vocab-parallel loss
    (``layout.cross_entropy``: each rank's own block, only per-row sums
    across ranks)."""
    if isinstance(logits, DTensor):
        return layout.cross_entropy(logits, labels, vocab_real, ignore_id)
    v_pad = logits.shape[-1]
    if v_pad > vocab_real:
        mask = torch.arange(v_pad, device=logits.device) >= vocab_real
        logits = torch.where(mask, torch.tensor(-1e9, dtype=logits.dtype,
                                                device=logits.device), logits)
    valid = labels != ignore_id
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(logp, labels_safe.long()[..., None],
                              dim=-1)[..., 0]
    return -torch.sum(ll * valid) / torch.clamp(torch.sum(valid), min=1)
