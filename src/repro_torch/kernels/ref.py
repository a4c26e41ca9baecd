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
    out = torch.stack([ok_s.sum(-1), x.sum(-1), (x * x).sum(-1), p.sum(-1)],
                      dim=-1)                                    # (S, W, 4)
    return out.permute(1, 0, 2).contiguous()


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
