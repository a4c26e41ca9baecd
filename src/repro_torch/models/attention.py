"""Attention: GQA/MQA/MHA, causal / sliding window, qk-norm, QKV bias —
full-sequence and cached-decode paths (counterpart of
``repro.models.attention``, the decoder-only subset).

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
ring buffer of the window's length.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models.layers import apply_rope, linear, pad_to, rms_norm

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


def _project_qkv(p: dict, cfg: AttnConfig, x: torch.Tensor):
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _rope(cfg: AttnConfig, q, k, q_pos, k_pos):
    if not cfg.use_rope:
        return q, k
    if cfg.mrope_sections is not None:
        raise ValueError("M-RoPE (apply_mrope) is not yet ported: it waits "
                         "for the VLM family")
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


def _out_proj(p: dict, out: torch.Tensor) -> torch.Tensor:
    """``einsum("...hk,hkd->...d", out, wo)``."""
    wo = p["wo"].to(out.dtype)
    return torch.matmul(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))


def full_attention(p: dict, cfg: AttnConfig, x: torch.Tensor, *,
                   positions: Optional[torch.Tensor] = None,
                   seg_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence self-attention (prefill / scoring).

    ``positions`` (B, S) query and key positions; the causal /
    sliding-window mask is built from them."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope(cfg, q, k, positions, positions)

    scores = _grouped_scores(q, k) / math.sqrt(cfg.head_dim)   # (B,Hk,G,S,T)
    mask = torch.ones((b, 1, 1, s, s), dtype=torch.bool, device=x.device)
    if cfg.causal and not cfg.cross:
        mask &= (positions[:, None, None, None, :]
                 <= positions[:, None, None, :, None])
    if cfg.window is not None and not cfg.cross:
        mask &= (positions[:, None, None, :, None]
                 - positions[:, None, None, None, :]) < cfg.window
    if seg_mask is not None:
        mask &= seg_mask[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    return _out_proj(p, _grouped_out(probs, v))


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
    q, k = _rope(cfg, q, k, pos[:, None], pos[:, None])

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    length = ck.shape[1]
    slot = (pos % length).long()                            # (B,)
    bi = torch.arange(b, device=x.device)
    ck.index_put_((bi, slot), k[:, 0].to(ck.dtype))
    cv.index_put_((bi, slot), v[:, 0].to(cv.dtype))
    cpos.index_put_((bi, slot), pos.to(cpos.dtype))

    scores = _grouped_scores(q, ck.to(x.dtype)) / math.sqrt(cfg.head_dim)
    ok = (cpos >= 0) & (cpos <= pos[:, None])
    if cfg.window is not None:
        ok &= (pos[:, None] - cpos) < cfg.window
    scores = torch.where(ok[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    out = _out_proj(p, _grouped_out(probs, cv.to(x.dtype)))
    return out, cache
