"""Wrapper of the CUDA kernel ``csrc/slot_extract.cu`` (the port of the TPU
kernel ``repro/kernels/slot_extract.py::slot_extract_pallas``).

:func:`slot_extract_cuda` checks its inputs, allocates the outputs (and,
for a window longer than one tile, the per-tile scratch) with
``torch.empty``, launches the one kernel on the current stream, and raises
if the launch is refused.  It never falls back to the plain version: that
is :func:`repro_torch.kernels.ref.slot_extract_ref`, which
:func:`repro_torch.kernels.ops.slot_extract` takes for CPU tensors only.
``slot_extract_cuda.launches`` counts the calls that launched the kernel.

The launch geometry is ``csrc/slot_tile.cuh``'s: one block per tile of
:data:`TILE_ROWS` window positions of one worker (:func:`tile_count`); a
window of more than one tile writes a scratch row per tile
(:func:`scratch_lanes`, :func:`tile_scratch`), which the worker's last
block folds in tile order, finding itself through an integer counter per
worker (:func:`tile_counters`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.data.formats import FIELD_BYTES
from repro_torch.kernels import _build

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             _P, _P, _P, _P, _P, _P, _P, _P, _P,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]

#: Window positions per block (``slot_tile.cuh``: ``tile::kTileRows``).
TILE_ROWS = 256


def tile_count(b: int) -> int:
    """Blocks per worker of a window of ``b`` positions: one per
    :data:`TILE_ROWS`."""
    if b < 1:
        raise ValueError("a window has at least one position")
    return -(-b // TILE_ROWS)


def scratch_lanes(s: int, g: int = 0, h: int = 0) -> int:
    """Floats of one tile's scratch row: the (S, 4) stats and, grouped
    (``g`` > 0), the (S, G, 4) cells and (S, 3, H) tallies, padded to a
    multiple of four (the fold reads 16 bytes at a time)."""
    lanes = s * 4 + (s * g * 4 + s * 3 * h if g > 0 else 0)
    return -(-lanes // 4) * 4


def tile_scratch(w: int, b: int, lanes: int, dev) -> torch.Tensor | None:
    """The (W, tiles, lanes) float32 scratch of a window longer than one
    tile, else None (a one-tile window is written straight to the
    outputs).  ``torch.empty`` from the caching allocator: no device work."""
    tiles = tile_count(b)
    if tiles == 1:
        return None
    return torch.empty((w, tiles, lanes), dtype=torch.float32, device=dev)


#: (device index, stream handle) -> that stream's tile counters, shared by
#: every kernel that folds across blocks: one stream runs their launches
#: in order.
_COUNTERS: dict = {}


def tile_counters(w: int, dev, stream: int) -> torch.Tensor:
    """The per-worker (per-row-block, for the rows kernels) int32 tile
    counters of ``stream`` on ``dev``, at least ``w`` of them.  Made with
    ``torch.zeros`` at the first call for a stream, and again, larger, for
    a call that needs more (one fill kernel then, none after: the kernels'
    last block leaves every counter at zero), so launches on one stream
    share them in order and two streams never share them."""
    key = (dev.index, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < w:
        # 64 covers any engine's worker count at once; chunk_agg's row
        # blocks (one per chunk) regrow it to their count
        cnt = _COUNTERS[key] = torch.zeros((max(w, 64),), dtype=torch.int32,
                                           device=dev)
    return cnt


def _lib():
    lib = _build.load("slot_extract")
    if lib.slot_extract_launch.argtypes is None:
        lib.slot_extract_launch.argtypes = _ARGTYPES
        lib.slot_extract_launch.restype = ctypes.c_int
        lib.slot_extract_tile_rows.argtypes = []
        lib.slot_extract_tile_rows.restype = ctypes.c_int
        if lib.slot_extract_tile_rows() != TILE_ROWS:
            raise RuntimeError("slot_extract.cu's tile size differs from "
                               "TILE_ROWS")
    return lib


def _check(t: torch.Tensor, name: str, dtype, dim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{dim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_packed(packed, device) -> tuple[int, int, int]:
    """packed (N, M_max, rec) uint8, 16-byte aligned (the kernels copy
    16-byte fields) -> (N, M_max, rec)."""
    _check(packed, "packed", torch.uint8, 3, device)
    if packed.data_ptr() % 16:
        raise ValueError("packed must start on a 16-byte boundary")
    return tuple(packed.shape)


def _check_window(idx, per_worker: dict, device) -> tuple[int, int]:
    """idx (W, B) and the (W,) int32 vectors in ``per_worker`` -> (W, B)."""
    _check(idx, "idx", torch.int32, 2, device)
    w, b = idx.shape
    for name, t in per_worker.items():
        _check(t, name, torch.int32, 1, device)
        if t.shape[0] != w:
            raise ValueError(f"{name} has {t.shape[0]} workers, idx has {w}")
    return w, b


def _check_plan(coeffs, lo, hi, is_count, gate, weights,
                device) -> tuple[int, int]:
    """The slot plan: coeffs/lo/hi (S, C), is_count/gate/weights (S,)
    float32 -> (S, C)."""
    _check(coeffs, "coeffs", torch.float32, 2, device)
    s, c = coeffs.shape
    for name, t in (("lo", lo), ("hi", hi)):
        _check(t, name, torch.float32, 2, device)
        if tuple(t.shape) != (s, c):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(s, c)}")
    for name, t in (("is_count", is_count), ("gate", gate),
                    ("weights", weights)):
        _check(t, name, torch.float32, 1, device)
        if t.shape[0] != s:
            raise ValueError(f"{name} has {t.shape[0]} slots, expected {s}")
    return s, c


def slot_extract_cuda(packed: torch.Tensor, jw: torch.Tensor,
                      idx: torch.Tensor, b_eff: torch.Tensor,
                      coeffs: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, is_count: torch.Tensor,
                      gate: torch.Tensor, weights: torch.Tensor,
                      return_cols: bool = False):
    """packed (N, M_max, 16·C) uint8, jw (W,) / idx (W, B) / b_eff (W,)
    int32, coeffs/lo/hi (S, C) and is_count/gate/weights (S,) float32, all
    contiguous on one CUDA device -> (stats (W, S, 4), cols (W, B, C) |
    None), float32."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"slot_extract_cuda needs CUDA tensors, got {dev}")
    n, m_max, rec = _check_packed(packed, dev)
    s, c = _check_plan(coeffs, lo, hi, is_count, gate, weights, dev)
    if rec != c * FIELD_BYTES:
        raise ValueError(f"record width {rec} != {FIELD_BYTES} x {c} columns")
    w, b = _check_window(idx, {"jw": jw, "b_eff": b_eff}, dev)
    if w == 0 or b == 0 or s == 0:
        raise ValueError("slot_extract_cuda needs W, B and S >= 1")
    lib = _lib()
    # per call: the outputs and, past one tile, the scratch (torch.empty,
    # no device work); the counters are made once per stream
    stats = torch.empty((w, s, 4), dtype=torch.float32, device=dev)
    cols = (torch.empty((w, b, c), dtype=torch.float32, device=dev)
            if return_cols else None)
    scratch = tile_scratch(w, b, scratch_lanes(s), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = tile_counters(w, dev, stream)
        err = lib.slot_extract_launch(
            packed.data_ptr(), n, m_max, c, jw.data_ptr(), idx.data_ptr(),
            b_eff.data_ptr(), coeffs.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            is_count.data_ptr(), gate.data_ptr(), weights.data_ptr(),
            w, b, s, stats.data_ptr(), 0 if cols is None else cols.data_ptr(),
            0 if scratch is None else scratch.data_ptr(),
            counters.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"slot_extract kernel launch failed: CUDA error "
                           f"{err}")
    slot_extract_cuda.launches += 1
    return stats, cols


slot_extract_cuda.launches = 0
