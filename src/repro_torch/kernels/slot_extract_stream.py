"""Wrappers of the CUDA kernels ``csrc/slot_extract_stream.cu``: the ports of
the TPU kernels ``repro/kernels/slot_extract.py::slot_extract_stream_pallas``
(:func:`slot_extract_stream_cuda`, raw slab) and
``slot_eval_decoded_pallas`` (:func:`slot_eval_decoded_cuda`, decoded slab).

Each checks its inputs (:func:`check_inputs`), allocates the outputs and,
for a window longer than one tile, the per-tile scratch (:func:`outputs`)
with ``torch.empty`` (the kernel writes every cache row, +0.0 off the
window), launches the one kernel on the current stream, and raises if the
launch is refused.  They never fall back to the plain versions
(:func:`repro_torch.kernels.ref.slot_extract_stream_ref` and
:func:`~repro_torch.kernels.ref.slot_eval_decoded_ref`), which
:mod:`repro_torch.kernels.ops` takes for CPU tensors only.  ``.launches``
on each wrapper counts the calls that launched its kernel.

The launch geometry is the packed kernels' (``csrc/slot_tile.cuh``, mirrored
in :mod:`repro_torch.kernels.slot_extract`): one block per tile of
:data:`~repro_torch.kernels.slot_extract.TILE_ROWS` window positions of one
worker, and the per-stream tile counters shared with the packed kernels, so
a mixed round's two launches on one stream take them in order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.data.formats import FIELD_BYTES
from repro_torch.kernels import _build
from repro_torch.kernels.slot_extract import (
    TILE_ROWS,
    _check,
    _check_plan,
    _check_window,
    scratch_lanes,
    tile_counters,
    tile_scratch,
)

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
             _P, _P, _P, _P, _P, _P,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
             ctypes.c_int, _P, _P, _P]


def _lib():
    lib = _build.load("slot_extract_stream")
    if lib.slot_extract_stream_launch.argtypes is None:
        for fn in (lib.slot_extract_stream_launch,
                   lib.slot_eval_decoded_launch):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.slot_extract_stream_tile_rows.argtypes = []
        lib.slot_extract_stream_tile_rows.restype = ctypes.c_int
        if lib.slot_extract_stream_tile_rows() != TILE_ROWS:
            raise RuntimeError("slot_extract_stream.cu's tile size differs "
                               "from TILE_ROWS")
    return lib


def check_inputs(decoded: bool, src: torch.Tensor, idx, b_eff, coeffs, lo,
                 hi, is_count, gate, weights, cache_cap: int,
                 m_before) -> tuple[int, int, int, int, int]:
    """The slab kernels' inputs, all on ``src``'s device: ``src`` a raw
    slab (W, R, 16·C) uint8 or a decoded slab (W, R, C) float32, contiguous
    and 16-byte aligned, the window, budgets and scan positions, and the
    plan -> (W, R, B, S, C)."""
    dev = src.device
    s, c = _check_plan(coeffs, lo, hi, is_count, gate, weights, dev)
    if decoded:
        _check(src, "dec", torch.float32, 3, dev)
        if src.shape[2] != c:
            raise ValueError(f"decoded width {src.shape[2]} != {c} columns")
    else:
        _check(src, "slab", torch.uint8, 3, dev)
        if src.shape[2] != c * FIELD_BYTES:
            raise ValueError(f"record width {src.shape[2]} != {FIELD_BYTES} "
                             f"x {c} columns")
    if src.data_ptr() % 16:
        raise ValueError(f"{'dec' if decoded else 'slab'} must start on a "
                         "16-byte boundary")
    w, b = _check_window(idx, {"b_eff": b_eff, "m_before": m_before}, dev)
    if src.shape[0] != w:
        raise ValueError(f"slab has {src.shape[0]} workers, idx has {w}")
    rows = src.shape[1]
    if w == 0 or b == 0 or s == 0 or rows == 0:
        raise ValueError("the slab kernels need W, B, S and slab rows >= 1")
    if cache_cap < 0:
        raise ValueError("cache_cap must be >= 0")
    if cache_cap * c >= 2 ** 31:
        raise ValueError("cache_cap x C must be below 2^31")
    return w, rows, b, s, c


def outputs(w: int, b: int, s: int, c: int, cache_cap: int, dev):
    """(stats (W, S, 4), cache rows (W, cache_cap, C) | None, tile scratch
    | None), all ``torch.empty``: the kernel writes every element of the
    first two, and the scratch only past one tile."""
    stats = torch.empty((w, s, 4), dtype=torch.float32, device=dev)
    cache = (torch.empty((w, cache_cap, c), dtype=torch.float32, device=dev)
             if cache_cap > 0 else None)
    return stats, cache, tile_scratch(w, b, scratch_lanes(s), dev)


def _launch(decoded: bool, src: torch.Tensor, idx, b_eff, coeffs, lo, hi,
            is_count, gate, weights, cache_cap: int, m_before):
    name = "slot_eval_decoded" if decoded else "slot_extract_stream"
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    w, rows, b, s, c = check_inputs(decoded, src, idx, b_eff, coeffs, lo, hi,
                                    is_count, gate, weights, cache_cap,
                                    m_before)
    lib = _lib()
    stats, cache, scratch = outputs(w, b, s, c, cache_cap, dev)
    fn = (lib.slot_eval_decoded_launch if decoded
          else lib.slot_extract_stream_launch)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = tile_counters(w, dev, stream)
        err = fn(src.data_ptr(), rows, c, idx.data_ptr(), b_eff.data_ptr(),
                 m_before.data_ptr(), coeffs.data_ptr(), lo.data_ptr(),
                 hi.data_ptr(), is_count.data_ptr(), gate.data_ptr(),
                 weights.data_ptr(), w, b, s, stats.data_ptr(),
                 0 if cache is None else cache.data_ptr(), cache_cap,
                 0 if scratch is None else scratch.data_ptr(),
                 counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return stats if cache is None else (stats, cache)


def slot_extract_stream_cuda(slab: torch.Tensor, idx: torch.Tensor,
                             b_eff: torch.Tensor, coeffs: torch.Tensor,
                             lo: torch.Tensor, hi: torch.Tensor,
                             is_count: torch.Tensor, gate: torch.Tensor,
                             weights: torch.Tensor, m_before: torch.Tensor,
                             cache_cap: int = 0):
    """slab (W, R, 16·C) uint8, idx (W, B) / b_eff (W,) / m_before (W,)
    int32, coeffs/lo/hi (S, C) and is_count/gate/weights (S,) float32, all
    contiguous on one CUDA device -> stats (W, S, 4) float32, or
    ``(stats, cache_rows (W, cache_cap, C))`` when ``cache_cap > 0``."""
    out = _launch(False, slab, idx, b_eff, coeffs, lo, hi, is_count, gate,
                  weights, cache_cap, m_before)
    slot_extract_stream_cuda.launches += 1
    return out


def slot_eval_decoded_cuda(dec: torch.Tensor, idx: torch.Tensor,
                           b_eff: torch.Tensor, coeffs: torch.Tensor,
                           lo: torch.Tensor, hi: torch.Tensor,
                           is_count: torch.Tensor, gate: torch.Tensor,
                           weights: torch.Tensor, m_before: torch.Tensor,
                           cache_cap: int = 0):
    """As :func:`slot_extract_stream_cuda` from a decoded slab
    ``dec (W, R, C)`` float32: no parse."""
    out = _launch(True, dec, idx, b_eff, coeffs, lo, hi, is_count, gate,
                  weights, cache_cap, m_before)
    slot_eval_decoded_cuda.launches += 1
    return out


slot_extract_stream_cuda.launches = 0
slot_eval_decoded_cuda.launches = 0
