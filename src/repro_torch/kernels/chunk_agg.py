"""Wrappers of the rows kernels ``csrc/chunk_agg.cu`` and
``csrc/round_stats.cu`` (the ports of the TPU kernels
``repro/kernels/chunk_agg.py::chunk_agg_pallas`` and
``repro/kernels/round_stats.py::round_stats_pallas``).

Both kernels parse every row of a block of fixed-width ASCII records,
evaluate Q linear plans and sum ``(rows counted, Σx, Σx², Σp)`` over the
first ``valid[l]`` rows of each block l: the chunks of a packed store
(:func:`chunk_agg_cuda`) or the workers' gathered window rows of a round
(:func:`~repro_torch.kernels.round_stats.round_stats_cuda`).  Each wrapper
checks its inputs, sizes the grid (:func:`rows_split`), allocates the
output and, for a row block split over more than one block, the scratch
rows with ``torch.empty``, launches the one kernel on the current stream
and raises if the launch is refused; it never falls back to the plain
versions (:func:`repro_torch.kernels.ref.chunk_agg_ref`,
:func:`~repro_torch.kernels.ref.round_stats_ref`).  ``.launches`` counts
the calls that launched the kernel.

The geometry is ``csrc/rows_tile.cuh``'s, mirrored here: a row block of R
rows is split over P blocks of ``block_rows`` rows each, walked in steps
of ``step_rows`` rows, thread t of a block summing row t of each of its
steps; with P > 1 the row block's last block folds the P partials in
block order, finding itself through the per-stream tile counters
(:func:`~repro_torch.kernels.slot_extract.tile_counters`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.data.formats import FIELD_BYTES
from repro_torch.kernels import _build
from repro_torch.kernels.slot_extract import _check, tile_counters

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P, _P,
             _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             _P, _P, _P, _P]

#: Threads a block (``rows_tile.cuh``: ``rows::kThreads``), and the rows of
#: a step at the widths whose rows fit a stage.
ROWS_THREADS = 128
#: Most bytes one stage of rows holds (the kernel sizes its stages by the
#: step this module picks).
STAGE_BYTES = 48 * 1024
#: Most blocks a row block is split over: the fold adds the partials one
#: after another.
MAX_BLOCKS = 64
#: Steps a block walks, at most, while the blocks allow: each is one more
#: addition in a thread's sums.
MAX_STEPS = 128
#: Additions of a block's reduction: 5 shuffle levels, then the warps.
REDUCE_DEPTH = 5 + ROWS_THREADS // 32


class RowsSplit(NamedTuple):
    blocks: int        # P, blocks a row block is split over
    step_rows: int     # rows a step (a stage)
    block_rows: int    # rows a block owns: ``steps`` steps
    steps: int         # steps a block walks, at most: rows a thread sums

    @property
    def chain_depth(self) -> int:
        """Additions on the longest path from a row's term to the output:
        the thread's steps, the block's reduction, the fold of P
        partials."""
        return self.steps + REDUCE_DEPTH + self.blocks


def step_rows(c: int) -> int:
    """Rows a step at width ``c``: :data:`ROWS_THREADS`, halved until a
    stage of them fits :data:`STAGE_BYTES`."""
    tr = ROWS_THREADS
    while tr > 1 and tr * FIELD_BYTES * c > STAGE_BYTES:
        tr //= 2
    return tr


def rows_split(l: int, r: int, c: int, slots: int) -> RowsSplit:
    """How ``l`` row blocks of ``r`` rows of width ``c`` are split, when
    the card holds ``slots`` blocks at once: enough blocks to fill the card
    about twice, but no more than steps, at most :data:`MAX_BLOCKS`, and at
    least as many as keep a block within :data:`MAX_STEPS` steps."""
    if l < 1 or r < 1 or c < 1 or slots < 1:
        raise ValueError("rows_split needs l, r, c and slots >= 1")
    tr = step_rows(c)
    total = -(-r // tr)
    want = max((2 * slots + l // 2) // l, -(-total // MAX_STEPS))
    p = max(1, min(want, total, MAX_BLOCKS))
    steps = -(-total // p)
    return RowsSplit(-(-total // steps), tr, steps * tr, steps)


#: (library name, C, Q, device index) -> blocks one SM holds at once
_SLOTS: dict = {}


def _lib(name: str):
    lib = _build.load(name)
    launch = getattr(lib, f"{name}_launch")
    if launch.argtypes is None:
        launch.argtypes = _ARGTYPES
        launch.restype = ctypes.c_int
        per_sm = getattr(lib, f"{name}_blocks_per_sm")
        per_sm.argtypes = [ctypes.c_int] * 3
        per_sm.restype = ctypes.c_int
        tpb = getattr(lib, f"{name}_threads_per_block")
        tpb.argtypes = []
        tpb.restype = ctypes.c_int
        if tpb() != ROWS_THREADS:
            raise RuntimeError(f"{name}.cu's block size differs from "
                               "ROWS_THREADS")
    return lib


def _slots(lib, name: str, c: int, q: int, dev) -> int:
    """Blocks of the kernel for (C, Q) the whole card holds at once."""
    key = (name, c, q, dev.index)
    slots = _SLOTS.get(key)
    if slots is None:
        with torch.cuda.device(dev):
            per_sm = getattr(lib, f"{name}_blocks_per_sm")(c, q, step_rows(c))
        if per_sm < 1:
            raise RuntimeError(f"{name}: no block fits an SM at C = {c}, "
                               f"Q = {q} (CUDA error {-per_sm})")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slots = _SLOTS[key] = per_sm * sms
    return slots


def launch_split(name: str, l: int, r: int, c: int, q: int,
                 dev) -> RowsSplit:
    """The split ``csrc/<name>.cu`` is launched with for ``l`` row blocks
    of ``r`` rows of width ``c`` and ``q`` plans on CUDA device ``dev``."""
    return rows_split(l, r, c, _slots(_lib(name), name, c, q, dev))


def _launch(name: str, raw: torch.Tensor, valid: torch.Tensor, coeffs,
            lo, hi) -> torch.Tensor:
    """raw (L, R, 16·C) uint8, valid (L,) int32, coeffs/lo/hi (Q, C)
    float32 -> (L, Q, 4) through ``csrc/<name>.cu``."""
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    _check(raw, "raw", torch.uint8, 3, dev)
    if raw.data_ptr() % 16:
        raise ValueError("raw must start on a 16-byte boundary")
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
    split = launch_split(name, n, r, c, q, dev)
    out = torch.empty((n, q, 4), dtype=torch.float32, device=dev)
    scratch = (torch.empty((n, split.blocks, q, 4), dtype=torch.float32,
                           device=dev) if split.blocks > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = tile_counters(n, dev, stream)
        err = getattr(_lib(name), f"{name}_launch")(
            raw.data_ptr(), n, r, c, valid.data_ptr(), coeffs.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), q, split.blocks, split.block_rows,
            split.step_rows, out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(),
            counters.data_ptr(), stream)
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
