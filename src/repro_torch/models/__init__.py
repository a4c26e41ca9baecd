"""Model zoo on PyTorch (counterpart of ``repro.models``): the six
families (dense and MoE decoder-only, VLM, encoder-decoder, Mamba2 hybrid,
xLSTM) with the reference's parameter names and layouts, random weights
from a seed, and ``convert.py`` to carry the reference's weights across."""

from repro_torch.models.model_zoo import build_model

__all__ = ["build_model"]
