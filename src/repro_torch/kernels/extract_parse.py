"""Wrapper of the CUDA kernel ``csrc/extract_parse.cu`` (the port of the TPU
kernel ``repro/kernels/extract_parse.py::extract_parse_pallas``).

:func:`extract_parse_cuda` checks its input, allocates the output, launches
on the current stream and raises if the launch is refused.  It never falls
back to the plain version (:func:`repro_torch.kernels.ref.parse_ascii_ref`),
which :func:`repro_torch.kernels.ops.extract_parse` takes for CPU tensors
only.  ``extract_parse_cuda.launches`` counts the calls that launched the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.data.formats import FIELD_BYTES
from repro_torch.kernels import _build
from repro_torch.kernels.slot_extract import _check


def _lib():
    lib = _build.load("extract_parse")
    if lib.extract_parse_launch.argtypes is None:
        lib.extract_parse_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.extract_parse_launch.restype = ctypes.c_int
    return lib


def extract_parse_cuda(raw: torch.Tensor, num_cols: int) -> torch.Tensor:
    """raw (T, 16·C) uint8, contiguous on a CUDA device -> (T, C) float32."""
    dev = raw.device
    if dev.type != "cuda":
        raise ValueError(f"extract_parse_cuda needs a CUDA tensor, got {dev}")
    _check(raw, "raw", torch.uint8, 2, dev)
    t, rec = raw.shape
    if rec != num_cols * FIELD_BYTES:
        raise ValueError(f"record width {rec} != {FIELD_BYTES} x {num_cols} "
                         "columns")
    out = torch.empty((t, num_cols), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.extract_parse_launch(raw.data_ptr(), t, num_cols,
                                       out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"extract_parse kernel launch failed: CUDA error "
                           f"{err}")
    extract_parse_cuda.launches += 1
    return out


extract_parse_cuda.launches = 0
