"""Public kernel entry points, dispatched on the device of their inputs
(counterpart of ``repro.kernels.ops``).

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain PyTorch version.  There is no fallback from one to the other: a build
or launch failure on the card raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.chunk_agg import chunk_agg_cuda
from repro_torch.kernels.extract_parse import extract_parse_cuda
from repro_torch.kernels.round_stats import round_stats_cuda
from repro_torch.kernels.slot_extract import slot_extract_cuda
from repro_torch.kernels.slot_extract_grouped import slot_extract_grouped_cuda
from repro_torch.kernels.slot_extract_stream import (
    slot_eval_decoded_cuda,
    slot_extract_stream_cuda,
)


def _as(dev, dtype):
    def cast(t):
        return torch.as_tensor(t, device=dev).to(dtype).contiguous()
    return cast


def _plan(dev, coeffs, lo, hi, is_count, gate, weights):
    f32 = _as(dev, torch.float32)
    coeffs, lo, hi, is_count, gate = (f32(a) for a in
                                      (coeffs, lo, hi, is_count, gate))
    weights = (torch.ones((coeffs.shape[0],), dtype=torch.float32, device=dev)
               if weights is None else f32(weights))
    return coeffs, lo, hi, is_count, gate, weights


def _unsupported(name, dev):
    return ValueError(f"{name} runs on CUDA or the CPU, not {dev}")


def extract_parse(raw: torch.Tensor, num_cols: int) -> torch.Tensor:
    """(T, rec_bytes) uint8 fixed-width ASCII -> (T, C) f32."""
    dev = raw.device
    if dev.type == "cuda":
        return extract_parse_cuda(raw.contiguous(), num_cols)
    if dev.type == "cpu":
        return _ref.parse_ascii_ref(raw, num_cols)
    raise _unsupported("extract_parse", dev)


def slot_extract(packed: torch.Tensor, jw, idx, b_eff, coeffs, lo, hi,
                 is_count, gate, weights=None, return_cols: bool = False,
                 gcol=None, gval=None, gact=None, salt=None,
                 tally_buckets: int = _ref.TALLY_BUCKETS):
    """Fused round extraction: gather + parse + slot eval + partial stats.

    packed (N, M, rec) uint8, jw (W,) chunk ids, idx (W, B) window rows,
    b_eff (W,), coeffs/lo/hi (S, C), is_count/gate/weights (S,) ->
    (stats (W, S, 4) = (m, Σx, Σx², Σp), cols (W, B, C) | None).

    The grouped-plane descriptors (``gcol (S,)``, ``gval``/``gact (S, G)``
    with G > 0, ``salt`` the round number) select the grouped variant, which
    also returns per-cell stats ``(W, S, G, 4)`` and salted group tallies
    ``(W, S, 3, H)``: ``(stats, cols | None, gstats, tal)``."""
    dev = packed.device
    i32 = _as(dev, torch.int32)
    jw, idx, b_eff = i32(jw), i32(idx), i32(b_eff)
    coeffs, lo, hi, is_count, gate, weights = _plan(
        dev, coeffs, lo, hi, is_count, gate, weights)
    if gval is not None and int(gval.shape[1]) > 0:
        f32 = _as(dev, torch.float32)
        gcol, gval, gact = i32(gcol), f32(gval), f32(gact)
        salt = i32(0 if salt is None else salt).reshape(1)
        if dev.type == "cuda":
            return slot_extract_grouped_cuda(
                packed, jw, idx, b_eff, coeffs, lo, hi, is_count, gate,
                weights, gcol, gval, gact, salt, tally_buckets,
                return_cols=return_cols)
        if dev.type == "cpu":
            return _ref.slot_extract_grouped_ref(
                packed, jw, idx, b_eff, coeffs, lo, hi, is_count, gate, gcol,
                gval, gact, salt, num_cols=int(coeffs.shape[1]),
                tally_buckets=tally_buckets, return_cols=return_cols,
                weights=weights)
        raise _unsupported("slot_extract_grouped", dev)
    if dev.type == "cuda":
        return slot_extract_cuda(packed, jw, idx, b_eff, coeffs, lo, hi,
                                 is_count, gate, weights,
                                 return_cols=return_cols)
    if dev.type == "cpu":
        return _ref.slot_extract_ref(packed, jw, idx, b_eff, coeffs, lo, hi,
                                     is_count, gate,
                                     num_cols=int(coeffs.shape[1]),
                                     return_cols=return_cols, weights=weights)
    raise _unsupported("slot_extract", dev)


def _rows(name: str, kernel, plain, raw: torch.Tensor, valid, coeffs, lo,
          hi) -> torch.Tensor:
    dev = raw.device
    f32 = _as(dev, torch.float32)
    valid = _as(dev, torch.int32)(valid)
    coeffs, lo, hi = f32(coeffs), f32(lo), f32(hi)
    if dev.type == "cuda":
        return kernel(raw.contiguous(), valid, coeffs, lo, hi)
    if dev.type == "cpu":
        return plain(raw, int(coeffs.shape[1]), coeffs, lo, hi, valid)
    raise _unsupported(name, dev)


def chunk_agg(raw: torch.Tensor, sizes, coeffs, lo, hi) -> torch.Tensor:
    """Full-chunk pass: raw (N, M, rec) uint8 and a plan ``coeffs/lo/hi
    (Q, C)`` -> (N, Q, 4) per-chunk ``(count, Σx, Σx², Σp)`` over the first
    ``sizes[j]`` rows of each chunk."""
    return _rows("chunk_agg", chunk_agg_cuda, _ref.chunk_agg_ref, raw, sizes,
                 coeffs, lo, hi)


def round_stats(slab: torch.Tensor, b_eff, coeffs, lo, hi) -> torch.Tensor:
    """A gathered round slab (W, B, rec) uint8 and budgets (W,) -> (W, Q, 4)
    partial stats over rows ``< b_eff[w]``."""
    return _rows("round_stats", round_stats_cuda, _ref.round_stats_ref, slab,
                 b_eff, coeffs, lo, hi)


def _stream(decoded: bool, src, idx, b_eff, coeffs, lo, hi, is_count, gate,
            weights, cache_cap: int, m_before):
    dev = src.device
    i32 = _as(dev, torch.int32)
    idx, b_eff = i32(idx), i32(b_eff)
    m_before = (torch.zeros((idx.shape[0],), dtype=torch.int32, device=dev)
                if m_before is None else i32(m_before))
    coeffs, lo, hi, is_count, gate, weights = _plan(
        dev, coeffs, lo, hi, is_count, gate, weights)
    if dev.type == "cuda":
        kernel = slot_eval_decoded_cuda if decoded else slot_extract_stream_cuda
        return kernel(src.contiguous(), idx, b_eff, coeffs, lo, hi, is_count,
                      gate, weights, m_before, cache_cap=cache_cap)
    if dev.type != "cpu":
        raise _unsupported("slot_eval_decoded" if decoded
                           else "slot_extract_stream", dev)
    if decoded:
        stats = _ref.slot_eval_decoded_ref(src, idx, b_eff, coeffs, lo, hi,
                                           is_count, gate, weights=weights)
        if cache_cap > 0:
            return stats, _ref.window_cache_rows_ref(
                _ref.gather_window(src, idx), b_eff, m_before, cache_cap)
        return stats
    c = int(coeffs.shape[1])
    stats = _ref.slot_extract_stream_ref(src, idx, b_eff, coeffs, lo, hi,
                                         is_count, gate, num_cols=c,
                                         weights=weights)
    if cache_cap > 0:
        return stats, _ref.stream_cache_rows_ref(src, idx, b_eff, m_before,
                                                 cache_cap, c)
    return stats


def slot_extract_stream(slab: torch.Tensor, idx, b_eff, coeffs, lo, hi,
                        is_count, gate, weights=None, cache_cap: int = 0,
                        m_before=None):
    """Round extraction from the round's per-worker slab (streaming
    residency): slab (W, R, rec) uint8 with worker w's chunk rows at
    ``slab[w]``, idx (W, B) window rows, b_eff (W,) -> stats (W, S, 4).

    ``cache_cap > 0`` also returns the synopsis-cache delta rows
    ``(W, cache_cap, C)`` (window position k at row ``m_before[w] + k``,
    zeros elsewhere): ``(stats, cache_rows)``."""
    return _stream(False, slab, idx, b_eff, coeffs, lo, hi, is_count, gate,
                   weights, cache_cap, m_before)


def slot_eval_decoded(dec: torch.Tensor, idx, b_eff, coeffs, lo, hi,
                      is_count, gate, weights=None, cache_cap: int = 0,
                      m_before=None):
    """The parse-once fast path: as :func:`slot_extract_stream` from an
    already decoded slab ``dec (W, R, C)`` float32 — no tokenize/parse."""
    return _stream(True, dec, idx, b_eff, coeffs, lo, hi, is_count, gate,
                   weights, cache_cap, m_before)
