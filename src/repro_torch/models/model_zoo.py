"""Model zoo dispatch: config -> model instance (counterpart of
``repro.models.model_zoo``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.vlm import VLM
from repro_torch.models.xlstm_model import XLSTMLM
from repro_torch.models.zamba import ZambaLM

_FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,       # MoE is a DecoderLM with num_experts > 0
    "encdec": EncDecLM,
    "vlm": VLM,
    "hybrid": ZambaLM,
    "xlstm": XLSTMLM,
}


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """The model for ``cfg`` on ``device`` (CUDA unless the caller names
    another), with random weights from ``seed`` (none drawn on the meta
    device)."""
    try:
        cls = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown model family: {cfg.family}") from None
    return cls(cfg, device=resolve_device(device), seed=seed)
