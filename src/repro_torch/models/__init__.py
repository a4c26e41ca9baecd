"""Model zoo on PyTorch (counterpart of ``repro.models``): the dense
decoder-only family (``DecoderLM``) with the reference's parameter names
and layouts, random weights from a seed, and ``convert.py`` to carry the
reference's weights across.  Other families are refused by name until
they are ported."""

from repro_torch.models.model_zoo import build_model

__all__ = ["build_model"]
