"""Wrapper of the CUDA kernel ``csrc/round_stats.cu`` (the port of the TPU
kernel ``repro/kernels/round_stats.py::round_stats_pallas``); the checks and
the launch are :mod:`repro_torch.kernels.chunk_agg`'s, whose kernel has the
same body.  ``round_stats_cuda.launches`` counts the calls that launched
the kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.chunk_agg import _launch


def round_stats_cuda(slab: torch.Tensor, b_eff: torch.Tensor,
                     coeffs: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """slab (W, B, 16·C) uint8 (window rows already gathered), b_eff (W,)
    int32, coeffs/lo/hi (Q, C) float32, contiguous on one CUDA device ->
    (W, Q, 4) float32 ``(m, Σx, Σx², Σp)`` over rows ``< b_eff[w]``."""
    out = _launch("round_stats", slab, b_eff, coeffs, lo, hi)
    round_stats_cuda.launches += 1
    return out


round_stats_cuda.launches = 0
