"""Attention: GQA/MQA/MHA, causal / bidirectional / cross / sliding
window, qk-norm, QKV bias, M-RoPE — full-sequence and cached-decode paths
(counterpart of ``repro.models.attention``).

Plain PyTorch ops in the reference's order: scores are computed in the
compute dtype and scaled by 1/sqrt(D), masked with -1e9, soft-maxed in
float32 and cast back.  (``scaled_dot_product_attention`` would fuse
those steps and round differently.)  Parameter layouts are the
reference's: ``wq (d, Hp, D)``, ``wk``/``wv (d, Hkp, D)``, ``wo (Hp, D,
d)``.

TP strategy, as in the reference: Q heads are padded up to a multiple of
the model-axis size; KV heads pad up to the smallest divisor of the padded
Q count that is at least the real count.  Padded Q heads attend normally
but their output-projection rows are zero, so logits are unchanged.

Decode writes the KV cache in place (``index_put_``) where the reference
returns a new cache from donated buffers; a sliding-window arch keeps a
ring buffer of the window's length.  On a mesh each rank attends over its
own block of the cache (``cached_attention``), which never moves: where
the cache is sharded over T the softmax is split over the ranks, as the
reference's compiled plan splits it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import layout
from repro_torch.models.layers import (
    apply_mrope, apply_rope, linear, pad_to, rms_norm)

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int          # real Q heads
    num_kv_heads: int       # real KV heads
    head_dim: int
    heads_padded: int       # Q heads after TP padding (>= num_heads)
    kv_heads_padded: int    # KV heads padded so heads_padded % kv_padded == 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None     # sliding-window size (None = full)
    cross: bool = False              # cross-attention (enc-dec)
    use_rope: bool = True
    mrope_sections: Optional[tuple] = None  # qwen2-vl


def padded_heads(num_heads: int, num_kv_heads: int,
                 tp: int) -> tuple[int, int]:
    """(heads_padded, kv_heads_padded) for a given model-axis size."""
    hp = pad_to(num_heads, tp)
    hk_pad = num_kv_heads
    while hp % hk_pad != 0:
        hk_pad += 1
    return hp, hk_pad


def real_head_mask(cfg: AttnConfig, device=None) -> torch.Tensor:
    """(heads_padded,) 1.0 for slots carrying a real architecture head.

    Padded-group layout: KV slot j serves Q slots [j*g', (j+1)*g'); the
    first ``g_real`` Q slots of the first ``num_kv_heads`` KV groups are
    real."""
    g_prime = cfg.heads_padded // cfg.kv_heads_padded
    g_real = cfg.num_heads // cfg.num_kv_heads
    slots = torch.arange(cfg.heads_padded, device=device)
    j = slots // g_prime
    i = slots % g_prime
    return ((j < cfg.num_kv_heads) & (i < g_real)).to(torch.float32)


def mask_padded_heads(params: dict, cfg: AttnConfig) -> dict:
    """Zero the output projection of non-real head slots (padded heads
    attend but contribute nothing)."""
    if (cfg.heads_padded == cfg.num_heads
            and cfg.kv_heads_padded == cfg.num_kv_heads):
        return params
    keep = real_head_mask(cfg, params["wo"].device)
    params = dict(params)
    params["wo"] = params["wo"] * keep[:, None, None]
    return params


def _project_qkv(p: dict, cfg: AttnConfig, x: torch.Tensor,
                 x_kv: Optional[torch.Tensor] = None):
    x_kv = x if x_kv is None else x_kv
    q = linear(x, p["wq"])
    k = linear(x_kv, p["wk"].to(x.dtype))
    v = linear(x_kv, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _rope(cfg: AttnConfig, q, k, q_pos, k_pos, positions3=None):
    if not cfg.use_rope:
        return q, k
    if cfg.mrope_sections is not None:
        return (apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta))
    return (apply_rope(q, q_pos, cfg.rope_theta),
            apply_rope(k, k_pos, cfg.rope_theta))


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,Hq,D), k (B,T,Hk,D) -> scores (B,Hk,G,S,T) with G=Hq/Hk."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, s, hk, hq // hk, d)
    return torch.einsum("bshgd,bthd->bhgst", qg, k)


def _grouped_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,Hk,G,S,T), v (B,T,Hk,D) -> (B,S,Hq,D)."""
    b, hk, g, s, t = probs.shape
    out = torch.einsum("bhgst,bthd->bshgd", probs, v)
    return out.reshape(b, s, hk * g, v.shape[-1])


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor], head_dim: int,
            reduce=None) -> torch.Tensor:
    """Masked grouped attention: q (B,S,Hq,D) over k, v (B,T,Hk,D) where
    ``mask`` (B,1,1,S|1,T) holds (None: everywhere) -> (B,S,Hq,D) in q's
    dtype.  With ``reduce`` (``layout.decode_attend``) k, v hold one block
    of T: the float32 softmax's row max and sum, and the output (in
    float32), are all-reduced over the other blocks."""
    scores = _grouped_scores(q, k) / math.sqrt(head_dim)       # (B,Hk,G,S,T)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    if reduce is None:
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
        return _grouped_out(probs, v)
    scores = scores.to(torch.float32)
    e = torch.exp(scores - reduce(scores.amax(-1, keepdim=True), "max"))
    probs = (e / reduce(e.sum(-1, keepdim=True), "sum")).to(q.dtype)
    return reduce(_grouped_out(probs, v).to(torch.float32), "sum").to(q.dtype)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, head_dim: int) -> torch.Tensor:
    """:func:`_attend`, on DTensors per rank (``layout.attend``)."""
    return layout.attend(lambda *a: _attend(*a, head_dim), q, k, v, mask)


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor],
                     head_dim: int) -> torch.Tensor:
    """:func:`_attend` of one decode query over a cache, on DTensors on
    each rank's own block of the cache (``layout.decode_attend``)."""
    return layout.decode_attend(
        lambda q, k, v, m, reduce: _attend(q, k, v, m, head_dim, reduce),
        q, k, v, mask)


def _out_proj(p: dict, out: torch.Tensor) -> torch.Tensor:
    """``einsum("...hk,hkd->...d", out, wo)``."""
    wo = p["wo"].to(out.dtype)
    if isinstance(wo, DTensor):
        return layout.contract(out, wo, 2)
    return torch.matmul(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def full_attention(p: dict, cfg: AttnConfig, x: torch.Tensor, *,
                   x_kv: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   kv_positions: Optional[torch.Tensor] = None,
                   positions3: Optional[torch.Tensor] = None,
                   seg_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill), self- or, with ``x_kv``
    (B, T, d), cross-attention.

    ``positions`` (B, S) query positions, ``kv_positions`` (B, T) key
    positions (the queries' for self-attention, ``arange(T)`` for
    cross-attention); the causal / sliding-window mask is built from them.
    ``positions3`` (3, B, S) are M-RoPE's position streams."""
    b, s, _ = x.shape
    t = s if x_kv is None else x_kv.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if kv_positions is None:
        kv_positions = positions if x_kv is None else torch.arange(
            t, device=x.device).expand(b, t)
    q, k, v = _project_qkv(p, cfg, x, x_kv)
    q, k, v = layout.attention_heads(x, cfg.kv_heads_padded, q, k, v)
    q, k = _rope(cfg, q, k, positions, kv_positions, positions3)
    mask = layout.batch_rows(lambda *a: _full_mask(cfg, *a), x, positions,
                             kv_positions, seg_mask)
    return _out_proj(p, _attention(q, k, v, mask, cfg.head_dim))


def _full_mask(cfg: AttnConfig, positions: torch.Tensor,
               kv_positions: torch.Tensor,
               seg_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The (B, 1, 1, S, T) mask of full-sequence attention: causal and
    sliding-window from the positions, and ``seg_mask`` (B, S, T)."""
    (b, s), t = positions.shape, kv_positions.shape[1]
    mask = torch.ones((b, 1, 1, s, t), dtype=torch.bool,
                      device=positions.device)
    if cfg.causal and not cfg.cross:
        mask &= (kv_positions[:, None, None, None, :]
                 <= positions[:, None, None, :, None])
    if cfg.window is not None and not cfg.cross:
        mask &= (positions[:, None, None, :, None]
                 - kv_positions[:, None, None, None, :]) < cfg.window
    if seg_mask is not None:
        mask &= seg_mask[:, None, None]
    return mask


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None, layers: int = 0) -> dict:
    """Cache buffers (with a leading ``layers`` dim when ``layers > 0``).
    Sliding-window archs allocate only the window (ring buffer); full
    attention allocates ``max_len``."""
    length = min(max_len, cfg.window) if cfg.window is not None else max_len
    lead = (layers,) if layers else ()
    shape = lead + (batch, length, cfg.kv_heads_padded, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(lead + (batch, length), -1, dtype=torch.int32,
                              device=device)}


def decode_attention(p: dict, cfg: AttnConfig, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor):
    """One-token decode step.  x (B, 1, d); pos (B,) absolute positions.

    Writes this token's K, V and position into ``cache`` in place (slot
    ``pos % length``) and returns ``(out (B,1,d), cache)``.  Cached
    absolute positions make masking exact: slots whose stored position is
    unwritten, in the future or outside the window are masked out."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)                       # (B,1,H,D)
    if cfg.mrope_sections is not None:
        # text-phase decode: all three position streams advance together
        q, k = _rope(cfg, q, k, None, None, pos[None, :, None].expand(3, b, 1))
    else:
        q, k = _rope(cfg, q, k, pos[:, None], pos[:, None])

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    length = ck.shape[1]
    slot = (pos % length).long()                            # (B,)
    bi = torch.arange(b, device=x.device)
    layout.write_slots(ck, bi, slot, k[:, 0].to(ck.dtype))
    layout.write_slots(cv, bi, slot, v[:, 0].to(cv.dtype))
    layout.write_slots(cpos, bi, slot, pos.to(cpos.dtype))

    ok = (cpos >= 0) & (cpos <= pos[:, None])
    if cfg.window is not None:
        ok &= (pos[:, None] - cpos) < cfg.window
    out = _out_proj(p, cached_attention(q, ck.to(x.dtype), cv.to(x.dtype),
                                        ok[:, None, None, None, :],
                                        cfg.head_dim))
    return out, cache
