"""Wrapper of the CUDA kernel ``csrc/slot_extract_grouped.cu`` (the port of
the TPU kernel ``repro/kernels/slot_extract.py::slot_extract_grouped_pallas``).

:func:`slot_extract_grouped_cuda` checks its inputs, allocates the outputs
(and, for a window longer than one tile, the per-tile scratch) with
``torch.empty``, launches the one kernel on the current stream, and raises
if the launch is refused.  The geometry, the scratch and the tile counters
are :mod:`repro_torch.kernels.slot_extract`'s.  It never falls back to the
plain version
(:func:`repro_torch.kernels.ref.slot_extract_grouped_ref`), which
:func:`repro_torch.kernels.ops.slot_extract` takes for CPU tensors only.
``slot_extract_grouped_cuda.launches`` counts the calls that launched the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.data.formats import FIELD_BYTES
from repro_torch.kernels import _build
from repro_torch.kernels.slot_extract import (
    TILE_ROWS,
    _check,
    _check_packed,
    _check_plan,
    _check_window,
    scratch_lanes,
    tile_counters,
    tile_scratch,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_longlong, _I,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]


def _lib():
    lib = _build.load("slot_extract_grouped")
    if lib.slot_extract_grouped_launch.argtypes is None:
        lib.slot_extract_grouped_launch.argtypes = _ARGTYPES
        lib.slot_extract_grouped_launch.restype = ctypes.c_int
        lib.slot_extract_grouped_tile_rows.argtypes = []
        lib.slot_extract_grouped_tile_rows.restype = ctypes.c_int
        if lib.slot_extract_grouped_tile_rows() != TILE_ROWS:
            raise RuntimeError("slot_extract_grouped.cu's tile size differs "
                               "from TILE_ROWS")
    return lib


def slot_extract_grouped_cuda(packed: torch.Tensor, jw: torch.Tensor,
                              idx: torch.Tensor, b_eff: torch.Tensor,
                              coeffs: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, is_count: torch.Tensor,
                              gate: torch.Tensor, weights: torch.Tensor,
                              gcol: torch.Tensor, gval: torch.Tensor,
                              gact: torch.Tensor, salt: torch.Tensor,
                              tally_buckets: int, return_cols: bool = False):
    """:func:`~repro_torch.kernels.slot_extract.slot_extract_cuda`'s inputs
    plus gcol (S,) int32, gval/gact (S, G) float32 and salt (1,) int32 (the
    round number), all contiguous on one CUDA device -> ``(stats (W, S, 4),
    cols (W, B, C) | None, gstats (W, S, G, 4), tal (W, S, 3, H))``
    float32, H = ``tally_buckets``."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"slot_extract_grouped_cuda needs CUDA tensors, "
                         f"got {dev}")
    n, m_max, rec = _check_packed(packed, dev)
    s, c = _check_plan(coeffs, lo, hi, is_count, gate, weights, dev)
    if rec != c * FIELD_BYTES:
        raise ValueError(f"record width {rec} != {FIELD_BYTES} x {c} columns")
    w, b = _check_window(idx, {"jw": jw, "b_eff": b_eff}, dev)
    _check(gcol, "gcol", torch.int32, 1, dev)
    _check(salt, "salt", torch.int32, 1, dev)
    if gcol.shape[0] != s or salt.shape[0] != 1:
        raise ValueError("gcol needs one entry per slot and salt one value")
    for name, t in (("gval", gval), ("gact", gact)):
        _check(t, name, torch.float32, 2, dev)
        if t.shape[0] != s or t.shape != gval.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({s}, G)")
    g, h = gval.shape[1], int(tally_buckets)
    if w == 0 or b == 0 or s == 0 or g == 0:
        raise ValueError("slot_extract_grouped_cuda needs W, B, S, G >= 1")
    if h < 2 or h > TILE_ROWS or h & (h - 1):
        raise ValueError(f"tally_buckets must be a power of two in "
                         f"[2, {TILE_ROWS}]")
    lib = _lib()

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    # per call: the outputs and, past one tile, the scratch (torch.empty,
    # no device work); the counters are made once per stream
    stats, gstats, tal = f32(w, s, 4), f32(w, s, g, 4), f32(w, s, 3, h)
    cols = f32(w, b, c) if return_cols else None
    scratch = tile_scratch(w, b, scratch_lanes(s, g, h), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = tile_counters(w, dev, stream)
        err = lib.slot_extract_grouped_launch(
            packed.data_ptr(), n, m_max, c, jw.data_ptr(), idx.data_ptr(),
            b_eff.data_ptr(), coeffs.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            is_count.data_ptr(), gate.data_ptr(), weights.data_ptr(),
            gcol.data_ptr(), gval.data_ptr(), gact.data_ptr(), salt.data_ptr(),
            w, b, s, g, h, stats.data_ptr(), gstats.data_ptr(),
            tal.data_ptr(), 0 if cols is None else cols.data_ptr(),
            0 if scratch is None else scratch.data_ptr(),
            counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"slot_extract_grouped kernel launch failed: CUDA "
                           f"error {err}")
    slot_extract_grouped_cuda.launches += 1
    return stats, cols, gstats, tal


slot_extract_grouped_cuda.launches = 0
