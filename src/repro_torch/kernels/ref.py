"""Plain PyTorch versions of the package's kernels (counterpart of
``repro.kernels.ref``).

They are the semantics contract the CUDA kernels are held against on the
card, and the execution path for tensors on the CPU.  Every contraction here
is written out as fused multiply-adds in a fixed order (float64 products
and sums, rounded to float32 once: the order the reference's contractions
take on the CPU), never as a matrix product, so no TF32 path can enter when
they run on the card; ``chip_smoke.py`` still turns TF32 off before it runs
them there.
"""

from __future__ import annotations

import torch

from repro_torch.core.queries import _lin
from repro_torch.data.formats import AsciiFixedFormat
from repro_torch.sampling.permutation import _M32, _mulc

# Group-discovery tally table width (a power of two; shared by the engine's
# plain path, the CUDA kernel and the host-side sketch fold).
TALLY_BUCKETS = 128
_HASH_SALT_MUL = 2654435761
_HASH_MIX_MUL = 2246822519


def tally_hash(vals: torch.Tensor, salt, buckets: int) -> torch.Tensor:
    """Salted multiplicative hash of f32 group values into ``[0, buckets)``:
    ``((bits(v) ^ salt·2654435761) · 2246822519) >> (32 − log2 H)`` with
    uint32 wraparound, as int64 (the reference's ``tally_hash``).

    ``salt`` (the round number, an int or an integer tensor) re-buckets
    every round, so two values that collide this round almost surely
    separate next round.  PyTorch has no CPU right shift for uint32: the
    bits are held in int64, masked to 32 bits, and the products split the
    constants into 16-bit halves."""
    lg = int(buckets).bit_length() - 1
    if (1 << lg) != int(buckets):
        raise ValueError("tally buckets must be a power of two")
    u = vals.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & _M32
    salt = torch.as_tensor(salt, device=vals.device).to(torch.int64) & _M32
    h = _mulc(u ^ _mulc(salt, _HASH_SALT_MUL), _HASH_MIX_MUL)
    return h >> (32 - lg)


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last dim as a pairwise tree of elementwise adds (zero-
    padded to a power of two).  The order depends on the length of that dim
    alone, so a row sums to the same bits whatever the tensor's other dims:
    a grouped cell's sums equal its fan-out slot's bit for bit.  (PyTorch's
    own reductions may take an order that follows the layout.)"""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def parse_ascii_ref(raw: torch.Tensor, num_cols: int) -> torch.Tensor:
    """(..., rec_bytes) uint8 fixed-width ASCII -> (..., C) f32."""
    return AsciiFixedFormat(num_cols).decode_ref(raw)


def eval_plan_ref(vals: torch.Tensor, coeffs: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor):
    """Linear-plan evaluation: vals (..., C) -> x (S, ...), p (S, ...).

    ``x`` is predicate-masked, ``p`` the 0/1 indicator; COUNT slots carry
    zero coefficients and callers use ``p`` for them."""
    v = vals[..., None, :]                                       # (..., 1, C)
    pred = torch.all((v >= lo) & (v < hi), dim=-1)               # (..., S)
    pf = pred.to(vals.dtype)
    x = _lin(vals, coeffs) * pf
    return torch.movedim(x, -1, 0), torch.movedim(pf, -1, 0)


def slot_budgets(b_eff: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Per-(slot, worker) counted budgets ``min(ceil(f32(w_s)·f32(b_eff)),
    b_eff)`` -> (S, W) int32 (the reference's f32 op order)."""
    b = b_eff.to(torch.int32)
    cap = torch.ceil(weights.to(torch.float32)[:, None]
                     * b.to(torch.float32)[None, :]).to(torch.int32)
    return torch.minimum(cap, b[None, :])


def _slot_stats_from_cols(cols: torch.Tensor, b_eff: torch.Tensor, coeffs,
                          lo, hi, is_count, gate,
                          weights=None) -> torch.Tensor:
    """Decoded window (W, B, C) f32 -> per-(worker, slot) stats (W, S, 4):
    slot eval, fairness-capped budget masking and the four sums."""
    b = cols.shape[1]
    x, p = eval_plan_ref(cols, coeffs, lo, hi)                   # (S, W, B)
    x = torch.where(is_count[:, None, None] > 0.0, p, x)
    if weights is None:
        weights = torch.ones((x.shape[0],), dtype=torch.float32,
                             device=cols.device)
    bs = slot_budgets(b_eff, weights)                            # (S, W)
    k = torch.arange(b, device=cols.device)
    ok_s = (k[None, None, :] < bs[:, :, None]).to(cols.dtype)    # (S, W, B)
    mask = ok_s * gate.to(cols.dtype)[:, None, None]
    x = x * mask
    p = p * mask
    out = torch.stack([sum_last(ok_s), sum_last(x), sum_last(x * x),
                       sum_last(p)], dim=-1)                     # (S, W, 4)
    return out.permute(1, 0, 2).contiguous()


def _group_stats_from_cols(cols: torch.Tensor, b_eff: torch.Tensor, coeffs,
                           lo, hi, is_count, gate, gcol, gval, gact, salt,
                           tally_buckets: int = TALLY_BUCKETS, weights=None):
    """Grouped back half: decoded window (W, B, C) -> per-(worker, slot,
    cell) stats (W, S, G, 4) and salted group tallies (W, S, 3, H).

    Cell lanes are ``(rows matched, Σx, Σx², Σp)`` under the masking of
    :func:`_slot_stats_from_cols`.  Every mask factor is an exact 0/1 float,
    so a tracked cell's sums are those of a fan-out slot whose predicate
    carries the group conjunct.  Cell G-1 is the ``__other__`` spill: the
    complement of the tracked cells (a row matches at most one tracked
    value), gated by its own live flag.  Tallies ``[Σp, Σp·v, Σp·v²]`` per
    hash bucket of the group value v exist only while the slot's
    ``__other__`` cell is live (it discovers groups)."""
    w, b, c = cols.shape
    x, p = eval_plan_ref(cols, coeffs, lo, hi)                   # (S, W, B)
    x = torch.where(is_count[:, None, None] > 0.0, p, x)
    if weights is None:
        weights = torch.ones((x.shape[0],), dtype=torch.float32,
                             device=cols.device)
    bs = slot_budgets(b_eff, weights)                            # (S, W)
    k = torch.arange(b, device=cols.device)
    ok_s = (k[None, None, :] < bs[:, :, None]).to(cols.dtype)    # (S, W, B)
    mask = ok_s * gate.to(cols.dtype)[:, None, None]
    x = x * mask
    p = p * mask
    gcol_c = torch.clamp(gcol.long(), 0, c - 1)
    colv = torch.movedim(cols, -1, 0)[gcol_c]                    # (S, W, B)
    gvalf = gval.to(cols.dtype)
    gactf = gact.to(cols.dtype)
    eq = (colv[:, None] == gvalf[:, :, None, None]).to(cols.dtype)
    trk = eq * gactf[:, :, None, None]                           # (S, G, W, B)
    other = ((1.0 - torch.sum(trk[:, :-1], dim=1))
             * gactf[:, -1][:, None, None])                      # (S, W, B)
    ind = torch.cat([trk[:, :-1], other[:, None]], dim=1)        # (S, G, W, B)
    gx = ind * x[:, None]
    gp = ind * p[:, None]
    cnt = sum_last(ind * mask[:, None])                          # (S, G, W)
    out = torch.stack([cnt, sum_last(gx), sum_last(gx * gx), sum_last(gp)],
                      dim=-1)                                    # (S, G, W, 4)
    gstats = out.permute(2, 0, 1, 3).contiguous()                # (W, S, G, 4)

    s_n, hb = colv.shape[0], int(tally_buckets)
    h = tally_hash(colv, salt, hb)                               # (S, W, B)
    pt = p * gactf[:, -1][:, None, None]
    moments = torch.stack([pt, pt * colv, pt * colv * colv], -1)  # (S,W,B,3)
    slot_ids = torch.arange(s_n, device=cols.device)[:, None, None]
    w_ids = torch.arange(w, device=cols.device)[None, :, None]
    flat = ((w_ids * s_n + slot_ids) * hb + h).reshape(-1)
    tal = torch.zeros((w * s_n * hb, 3), dtype=cols.dtype,
                      device=cols.device).index_add_(
        0, flat, moments.reshape(-1, 3))
    tal = tal.reshape(w, s_n, hb, 3).permute(0, 1, 3, 2).contiguous()
    return gstats, tal


def slot_extract_grouped_ref(packed: torch.Tensor, jw: torch.Tensor,
                             idx: torch.Tensor, b_eff: torch.Tensor, coeffs,
                             lo, hi, is_count, gate, gcol, gval, gact, salt,
                             num_cols: int,
                             tally_buckets: int = TALLY_BUCKETS,
                             return_cols: bool = False, weights=None):
    """Grouped fused extraction, plain version of
    ``csrc/slot_extract_grouped.cu`` (packed residency):
    :func:`slot_extract_ref`'s outputs plus per-cell stats and group
    tallies -> ``(stats (W, S, 4), cols | None, gstats (W, S, G, 4),
    tal (W, S, 3, H))``."""
    raw = packed[jw.long()[:, None], idx.long()]                 # (W, B, rec)
    cols = parse_ascii_ref(raw, num_cols)                        # (W, B, C)
    stats = _slot_stats_from_cols(cols, b_eff, coeffs, lo, hi, is_count, gate,
                                  weights)
    gstats, tal = _group_stats_from_cols(cols, b_eff, coeffs, lo, hi,
                                         is_count, gate, gcol, gval, gact,
                                         salt, tally_buckets, weights)
    return stats, (cols if return_cols else None), gstats, tal


def _rows_stats(vals: torch.Tensor, coeffs, lo, hi,
                valid: torch.Tensor) -> torch.Tensor:
    """Decoded rows (L, R, C) with a validity count per leading row block
    (L,) -> (L, Q, 4) = (rows valid, Σx, Σx², Σp) over the first
    ``valid[l]`` rows; the count lane is broadcast over Q."""
    x, p = eval_plan_ref(vals, coeffs, lo, hi)                   # (Q, L, R)
    r = vals.shape[1]
    ok = (torch.arange(r, device=vals.device)[None, :]
          < valid.to(torch.int64)[:, None]).to(vals.dtype)       # (L, R)
    x = x * ok[None]
    p = p * ok[None]
    cnt = sum_last(ok)[None].expand(x.shape[0], -1)              # (Q, L)
    out = torch.stack([cnt, sum_last(x), sum_last(x * x), sum_last(p)],
                      dim=-1)
    return out.permute(1, 0, 2).contiguous()


def chunk_agg_ref(raw: torch.Tensor, num_cols: int, coeffs, lo, hi,
                  sizes: torch.Tensor) -> torch.Tensor:
    """Full-chunk parse + evaluation + aggregate, plain version of
    ``csrc/chunk_agg.cu``: raw (N, M, rec) uint8, sizes (N,) ->
    (N, Q, 4) with ``out[j, q] = (m_valid, Σx, Σx², Σp)`` over the first
    ``sizes[j]`` rows of chunk j."""
    return _rows_stats(parse_ascii_ref(raw, num_cols), coeffs, lo, hi, sizes)


def round_stats_ref(slab: torch.Tensor, num_cols: int, coeffs, lo, hi,
                    b_eff: torch.Tensor) -> torch.Tensor:
    """Budget-masked stats of a pre-gathered round slab, plain version of
    ``csrc/round_stats.cu``: slab (W, B, rec) uint8, b_eff (W,) ->
    (W, Q, 4) = (m, Σx, Σx², Σp) over rows ``< b_eff[w]``."""
    return _rows_stats(parse_ascii_ref(slab, num_cols), coeffs, lo, hi, b_eff)


def slot_extract_ref(packed: torch.Tensor, jw: torch.Tensor, idx: torch.Tensor,
                     b_eff: torch.Tensor, coeffs, lo, hi, is_count, gate,
                     num_cols: int, return_cols: bool = False, weights=None):
    """Fused round extraction, plain version of ``csrc/slot_extract.cu``.

    packed (N, M, rec) uint8, jw (W,) chunk ids, idx (W, B) window rows,
    b_eff (W,), coeffs/lo/hi (S, C), is_count/gate/weights (S,) ->
    (stats (W, S, 4) = (m, Σx, Σx², Σp), cols (W, B, C) | None)."""
    raw = packed[jw.long()[:, None], idx.long()]                 # (W, B, rec)
    cols = parse_ascii_ref(raw, num_cols)                        # (W, B, C)
    stats = _slot_stats_from_cols(cols, b_eff, coeffs, lo, hi, is_count, gate,
                                  weights)
    return stats, (cols if return_cols else None)


def slot_extract_stream_ref(slab: torch.Tensor, idx: torch.Tensor,
                            b_eff: torch.Tensor, coeffs, lo, hi, is_count,
                            gate, num_cols: int,
                            weights=None) -> torch.Tensor:
    """Slab-streaming round extraction, plain version of
    ``csrc/slot_extract_stream.cu`` (raw): :func:`slot_extract_ref` with the
    round's per-worker slab ``(W, R, rec)`` as the source — worker w's rows
    at ``slab[w]``, no chunk-id indirection -> stats (W, S, 4)."""
    w = idx.shape[0]
    jw = torch.arange(w, dtype=torch.int32, device=slab.device)
    stats, _ = slot_extract_ref(slab, jw, idx, b_eff, coeffs, lo, hi,
                                is_count, gate, num_cols=num_cols,
                                weights=weights)
    return stats


def gather_window(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather worker w's window rows ``src[w, idx[w]]`` -> (W, B, ...)."""
    w = idx.shape[0]
    return src[torch.arange(w, device=src.device)[:, None], idx.long()]


def slot_eval_decoded_ref(dec: torch.Tensor, idx: torch.Tensor,
                          b_eff: torch.Tensor, coeffs, lo, hi, is_count, gate,
                          weights=None) -> torch.Tensor:
    """Decoded-input round extraction, plain version of
    ``csrc/slot_extract_stream.cu`` (decoded): worker w's already decoded
    rows at ``dec (W, R, C)[w]`` go straight to slot evaluation ->
    stats (W, S, 4)."""
    return _slot_stats_from_cols(gather_window(dec, idx), b_eff, coeffs, lo,
                                 hi, is_count, gate, weights)


def window_cache_rows_ref(cols: torch.Tensor, b_eff: torch.Tensor,
                          m_before: torch.Tensor,
                          cache_cap: int) -> torch.Tensor:
    """Synopsis-cache delta rows from a decoded window: cols (W, B, C),
    b_eff (W,), m_before (W,) scan positions -> (W, cache_cap, C) where row
    ``r`` holds ``cols[w, r - m_before[w]]`` when that window position
    exists (``0 <= r - m_before < b_eff``) and zeros otherwise."""
    b = cols.shape[1]
    k = (torch.arange(cache_cap, dtype=torch.int32, device=cols.device)[None]
         - m_before.to(torch.int32)[:, None])                    # (W, cap)
    valid = (k >= 0) & (k < b_eff.to(torch.int32)[:, None])
    rows = torch.take_along_dim(
        cols, torch.clamp(k, 0, b - 1).long()[..., None], dim=1)
    return rows * valid[..., None].to(cols.dtype)


def stream_cache_rows_ref(slab: torch.Tensor, idx: torch.Tensor,
                          b_eff: torch.Tensor, m_before: torch.Tensor,
                          cache_cap: int, num_cols: int) -> torch.Tensor:
    """Raw-slab version of the in-kernel cache emission: gather + parse the
    window, then select the cache rows (:func:`window_cache_rows_ref`)."""
    cols = parse_ascii_ref(gather_window(slab, idx), num_cols)
    return window_cache_rows_ref(cols, b_eff, m_before, cache_cap)
