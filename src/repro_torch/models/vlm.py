"""Qwen2-VL-style VLM backbone: the decoder LM with M-RoPE and a stubbed
vision frontend (counterpart of ``repro.models.vlm``).

As in the reference, the modality frontend is a stub: the batch supplies
pre-computed patch embeddings ``vis_embeds (B, S_vis, d_model)``; the
backbone concatenates them with the text embeddings and runs M-RoPE
attention with the 3-stream (t, h, w) position ids ``positions3 (3, B,
S)``.  Labels cover the text positions only.  The parameters are the
decoder LM's (the reference's ``VLM.init`` is its LM's), and decode is the
LM's text-phase decode (all three streams advance with ``pos``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.module import unstack_layers
from repro_torch.models.transformer import DecoderLM


def build_positions3(batch: int, s_vis: int, s_txt: int,
                     grid: tuple[int, int] = None) -> np.ndarray:
    """Default M-RoPE id layout: vision tokens on an (h, w) grid at t = 0,
    text tokens advancing all three streams together from ``max(grid)``
    after the vision span.  (3, batch, s_vis + s_txt) int32."""
    if grid is None:
        side = max(int(np.sqrt(s_vis)), 1)
        grid = (side, (s_vis + side - 1) // side)
    h_ids = (np.arange(s_vis) // grid[1]) % grid[0]
    w_ids = np.arange(s_vis) % grid[1]
    t_ids = np.zeros(s_vis)
    base = max(grid[0], grid[1])
    txt = base + np.arange(s_txt)
    pos3 = np.stack([
        np.concatenate([t_ids, txt]),
        np.concatenate([h_ids, txt]),
        np.concatenate([w_ids, txt]),
    ])                                                   # (3, S)
    return np.broadcast_to(pos3[:, None],
                           (3, batch, s_vis + s_txt)).astype(np.int32)


class VLM(DecoderLM):
    """``forward``/``loss`` (serving) and ``apply``/``loss_fn``
    (functional) take the batch: ``vis_embeds``, ``tokens``,
    ``positions3`` [, ``labels``]."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        if cfg.mrope_sections is None:
            raise ValueError(f"{cfg.name}: the VLM needs mrope_sections")
        super().__init__(cfg, device=device, seed=seed)

    def _vlm_run(self, w: dict, layers, batch: dict, remat: bool):
        vis = batch["vis_embeds"].to(self.compute_dtype)
        txt = L.embed_apply(w, batch["tokens"]).to(vis.dtype)
        return self._run(w, layers, None, None, remat,
                         positions3=batch["positions3"],
                         inputs_embeds=torch.cat([vis, txt], dim=1))

    def _vlm_loss(self, out, batch: dict) -> torch.Tensor:
        logits, aux = out
        s_vis = batch["vis_embeds"].shape[1]
        ce = L.cross_entropy_loss(logits[:, s_vis:], batch["labels"],
                                  self.cfg.vocab_size)
        return ce + 0.01 * aux

    @torch.no_grad()
    def forward(self, batch: dict):
        """-> (logits (B, S_vis + S_txt, V_pad), aux loss)."""
        w = self.compute_params()
        return self._vlm_run(w, w["layers"], batch, remat=False)

    def loss(self, batch: dict) -> torch.Tensor:
        return self._vlm_loss(self.forward(batch), batch)

    def apply(self, params: dict, batch: dict):
        return self._vlm_run(params, unstack_layers(params["layers"]), batch,
                             remat=self.cfg.remat)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        return self._vlm_loss(self.apply(params, batch), batch)

    def prefill(self, batch: dict) -> torch.Tensor:
        """The forward's last-position logits (the prefill shape)."""
        return self.forward(batch)[0][:, -1:]
