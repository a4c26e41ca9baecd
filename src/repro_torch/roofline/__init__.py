"""Roofline accounting of the port's steps, priced with the H100's constants
(counterpart of ``repro.roofline``; no hardware required)."""

from repro_torch.roofline.analysis import analyze_step, collective_bytes
from repro_torch.roofline.hw import H100_SXM

__all__ = ["H100_SXM", "analyze_step", "collective_bytes"]
