"""Public kernel entry points, dispatched on the device of their inputs
(counterpart of ``repro.kernels.ops``).

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to its
plain PyTorch version.  There is no fallback from one to the other: a build
or launch failure on the card raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.slot_extract import slot_extract_cuda


def slot_extract(packed: torch.Tensor, jw, idx, b_eff, coeffs, lo, hi,
                 is_count, gate, weights=None, return_cols: bool = False):
    """Fused round extraction: gather + parse + slot eval + partial stats.

    packed (N, M, rec) uint8, jw (W,) chunk ids, idx (W, B) window rows,
    b_eff (W,), coeffs/lo/hi (S, C), is_count/gate/weights (S,) ->
    (stats (W, S, 4) = (m, Σx, Σx², Σp), cols (W, B, C) | None)."""
    dev = packed.device

    def i32(t):
        return torch.as_tensor(t, device=dev).to(torch.int32).contiguous()

    def f32(t):
        return torch.as_tensor(t, device=dev).to(torch.float32).contiguous()

    jw, idx, b_eff = i32(jw), i32(idx), i32(b_eff)
    coeffs, lo, hi, is_count, gate = (f32(a) for a in
                                      (coeffs, lo, hi, is_count, gate))
    weights = (torch.ones((coeffs.shape[0],), dtype=torch.float32, device=dev)
               if weights is None else f32(weights))
    if dev.type == "cuda":
        return slot_extract_cuda(packed, jw, idx, b_eff, coeffs, lo, hi,
                                 is_count, gate, weights,
                                 return_cols=return_cols)
    if dev.type == "cpu":
        return _ref.slot_extract_ref(packed, jw, idx, b_eff, coeffs, lo, hi,
                                     is_count, gate,
                                     num_cols=int(coeffs.shape[1]),
                                     return_cols=return_cols, weights=weights)
    raise ValueError(f"slot_extract runs on CUDA or the CPU, not {dev}")
