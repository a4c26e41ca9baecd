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
