"""Model zoo dispatch: config -> model instance (counterpart of
``repro.models.model_zoo``).  The dense family is ported; every other
family is refused by name."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM

_NOT_YET = {
    "moe": "models/moe.py",
    "encdec": "models/encdec.py",
    "vlm": "models/vlm.py",
    "hybrid": "models/ssm.py and models/zamba.py",
    "xlstm": "models/xlstm.py and models/xlstm_model.py",
}


def build_model(cfg: ModelConfig, device=None, seed: int = 0) -> DecoderLM:
    """The model for ``cfg`` on ``device`` (CUDA unless the caller names
    another), with random weights from ``seed``."""
    if cfg.family in _NOT_YET:
        raise ValueError(f"model family {cfg.family!r} ({cfg.name}) is not "
                         f"yet ported: {_NOT_YET[cfg.family]}")
    if cfg.family != "dense":
        raise ValueError(f"unknown model family: {cfg.family}")
    return DecoderLM(cfg, device=resolve_device(device), seed=seed)
