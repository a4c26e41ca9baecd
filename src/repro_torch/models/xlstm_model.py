"""xLSTM LM: mLSTM blocks with sLSTM blocks at ``cfg.slstm_at``, embedding,
final norm and tied unembedding (counterpart of
``repro.models.xlstm_model``).

The blocks are of two kinds and are not stacked: ``blocks`` is a tuple of
per-layer dicts (``blocks.<i>.*``), run by a Python loop.  Decode carries
each block's recurrent state (O(1) in the sequence), ignores ``pos``, and
its cache defaults to float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import layout
from repro_torch.distributed.autoshard import constrain
from repro_torch.models import layers as L
from repro_torch.models import xlstm as X
from repro_torch.models.module import LMModule, param


class XLSTMLM(LMModule):
    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__(cfg)
        self.xcfg = X.XLSTMConfig(d_model=cfg.d_model,
                                  num_heads=cfg.num_heads,
                                  chunk=cfg.ssm_chunk)
        self.kinds = ["slstm" if i in cfg.slstm_at else "mlstm"
                      for i in range(cfg.num_layers)]
        self.embedding = param(L.pad_to(cfg.vocab_size, 256), cfg.d_model,
                               device=device)
        self.final_norm = param(cfg.d_model, device=device)
        self.blocks = nn.ModuleList(
            (X.SLSTMBlock if kind == "slstm" else X.MLSTMBlock)(
                self.xcfg, device) for kind in self.kinds)
        self.reset_parameters(seed)

    def _run(self, w: dict, blocks, tokens: torch.Tensor,
             remat: bool) -> torch.Tensor:
        x = constrain(self._embed(w, tokens), "btd")
        for kind, bp in zip(self.kinds, blocks):
            fwd = X.slstm_forward if kind == "slstm" else X.mlstm_forward
            fwd = layout.batch_local(fwd)
            x = constrain(
                checkpoint(fwd, bp, self.xcfg, x, use_reentrant=False)
                if remat else fwd(bp, self.xcfg, x), "btd")
        x = L.rms_norm(x, w["final_norm"])
        return L.unembed_apply(w, x, tied=True)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V_pad)."""
        w = self.compute_params()
        return self._run(w, w["blocks"], tokens, remat=False)

    def loss(self, batch: dict) -> torch.Tensor:
        return L.cross_entropy_loss(self.forward(batch["tokens"]),
                                    batch["labels"], self.cfg.vocab_size)

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.forward(tokens)[:, -1:]

    # ------------------------------------------------ functional (train) --
    def apply(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The reference's ``forward(params, tokens)`` on its tree
        (``blocks`` a tuple), differentiable in ``params``."""
        return self._run(params, params["blocks"], tokens, self.cfg.remat)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        return L.cross_entropy_loss(self.apply(params, batch["tokens"]),
                                    batch["labels"], self.cfg.vocab_size)

    # ------------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.float32) -> tuple:
        del max_len  # recurrent state: O(1) in sequence length
        dev = self.embedding.device
        return tuple((X.init_slstm_cache if kind == "slstm"
                      else X.init_mlstm_cache)(batch, self.xcfg, dtype, dev)
                     for kind in self.kinds)

    @torch.no_grad()
    def decode_step(self, cache: tuple, tokens: torch.Tensor, pos=None):
        """tokens (B, 1) -> (logits (B, 1, V_pad), cache), the cache written
        in place; ``pos`` is ignored (the recurrences are position-free)."""
        w = self.compute_params()
        x = self._embed(w, tokens)
        for kind, bp, c in zip(self.kinds, w["blocks"], cache):
            step = X.slstm_decode if kind == "slstm" else X.mlstm_decode
            x = step(bp, self.xcfg, x, c)
        x = L.rms_norm(x, w["final_norm"])
        return L.unembed_apply(w, x, tied=True), cache
