"""Wrappers of the rows kernels ``csrc/chunk_agg.cu`` and
``csrc/round_stats.cu`` (the ports of the TPU kernels
``repro/kernels/chunk_agg.py::chunk_agg_pallas`` and
``repro/kernels/round_stats.py::round_stats_pallas``).

Both kernels parse every row of a block of fixed-width ASCII records,
evaluate Q linear plans and sum ``(rows counted, Σx, Σx², Σp)`` over the
first ``valid[l]`` rows of each block l: the chunks of a packed store
(:func:`chunk_agg_cuda`) or the workers' gathered window rows of a round
(:func:`~repro_torch.kernels.round_stats.round_stats_cuda`).  Each wrapper
checks its inputs, allocates the output and per-block scratch, launches on
the current stream and raises if the launch is refused; it never falls back
to the plain versions (:func:`repro_torch.kernels.ref.chunk_agg_ref`,
:func:`~repro_torch.kernels.ref.round_stats_ref`).  ``.launches`` counts
the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.data.formats import FIELD_BYTES
from repro_torch.kernels import _build
from repro_torch.kernels.slot_extract import _check

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P,
             _P, _P, _P, ctypes.c_int, _P, _P, _P]


def _launch(name: str, raw: torch.Tensor, valid: torch.Tensor, coeffs,
            lo, hi) -> torch.Tensor:
    """raw (L, R, 16·C) uint8, valid (L,) int32, coeffs/lo/hi (Q, C)
    float32 -> (L, Q, 4) through ``csrc/<name>.cu``."""
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    _check(raw, "raw", torch.uint8, 3, dev)
    n, r, rec = raw.shape
    _check(valid, "valid rows", torch.int32, 1, dev)
    _check(coeffs, "coeffs", torch.float32, 2, dev)
    q, c = coeffs.shape
    for nm, t in (("lo", lo), ("hi", hi)):
        _check(t, nm, torch.float32, 2, dev)
        if tuple(t.shape) != (q, c):
            raise ValueError(f"{nm} has shape {tuple(t.shape)}, expected "
                             f"{(q, c)}")
    if rec != c * FIELD_BYTES:
        raise ValueError(f"record width {rec} != {FIELD_BYTES} x {c} columns")
    if valid.shape[0] != n:
        raise ValueError(f"{valid.shape[0]} valid counts for {n} row blocks")
    if n == 0 or r == 0 or q == 0:
        raise ValueError(f"{name}_cuda needs at least one block, row and plan")
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    tpb = getattr(lib, f"{name}_threads_per_block")
    if launch.argtypes is None:
        launch.argtypes = _ARGTYPES
        launch.restype = ctypes.c_int
        tpb.argtypes = []
        tpb.restype = ctypes.c_int
    nblk = (r + tpb() - 1) // tpb()
    partials = torch.empty((n, nblk, q, 4), dtype=torch.float32, device=dev)
    out = torch.empty((n, q, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(raw.data_ptr(), n, r, c, valid.data_ptr(),
                     coeffs.data_ptr(), lo.data_ptr(), hi.data_ptr(), q,
                     partials.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def chunk_agg_cuda(raw: torch.Tensor, sizes: torch.Tensor,
                   coeffs: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor) -> torch.Tensor:
    """raw (N, M, 16·C) uint8, sizes (N,) int32, coeffs/lo/hi (Q, C)
    float32, contiguous on one CUDA device -> (N, Q, 4) float32 per-chunk
    ``(rows valid, Σx, Σx², Σp)`` over the first ``sizes[j]`` rows."""
    out = _launch("chunk_agg", raw, sizes, coeffs, lo, hi)
    chunk_agg_cuda.launches += 1
    return out


chunk_agg_cuda.launches = 0
