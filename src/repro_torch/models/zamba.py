"""Zamba2-style hybrid: a Mamba2 backbone with one weight-SHARED
attention + SwiGLU block applied every ``shared_attn_every`` layers
(counterpart of ``repro.models.zamba``).

The shared block's input is ``concat(x, x0)`` (the current activations and
the original embeddings) through a per-site projection ``site_proj[si]``,
the only unshared piece.  The shared attention runs with
``cfg.long_window`` as its sliding window, so decode keeps a ring buffer of
the window's length.  Sites sit after layers ``every-1, 2·every-1, ...``;
the Mamba layers between them run as spans.

Parameters: ``embedding``, ``final_norm``, ``shared.{ln1, attn, ln2,
mlp}``, ``site_proj (sites, 2d, d)`` and ``layers.<i>.{ln, m}`` (the
reference stacks ``layers`` on ``(L, ...)``).  The decode cache is the
reference's: ``{"mamba": float32 (L, ...) ssm / conv states, "shared":
(sites, ...) KV ring buffers}``, written in place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.autoshard import constrain
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.module import (
    MLP, Attention, LMModule, param, unstack_layers)


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, m: ssm.MambaConfig, device):
        super().__init__()
        self.ln = param(cfg.d_model, device=device)
        self.m = ssm.Mamba(m, device)


class SharedBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, a: attn.AttnConfig, device):
        super().__init__()
        self.ln1 = param(cfg.d_model, device=device)
        self.attn = Attention(a, device)
        self.ln2 = param(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "swiglu", device)


class ZambaLM(LMModule):
    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__(cfg)
        hp, hkp = attn.padded_heads(cfg.num_heads, cfg.num_kv_heads, cfg.tp)
        self.acfg = attn.AttnConfig(
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
            heads_padded=hp, kv_heads_padded=hkp, causal=True,
            window=cfg.long_window, rope_theta=cfg.rope_theta)
        m = ssm.MambaConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                            headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk)
        self.mcfg = ssm.MambaConfig(
            d_model=cfg.d_model, d_state=cfg.ssm_state,
            headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk,
            heads_padded=L.pad_to(m.nheads, cfg.tp))
        self.sites = list(range(cfg.shared_attn_every - 1, cfg.num_layers,
                                cfg.shared_attn_every))
        d = cfg.d_model
        self.embedding = param(L.pad_to(cfg.vocab_size, 256), d,
                               device=device)
        self.final_norm = param(d, device=device)
        self.shared = SharedBlock(cfg, self.acfg, device)
        self.site_proj = param(len(self.sites), 2 * d, d, device=device)
        self.layers = nn.ModuleList(MambaLayer(cfg, self.mcfg, device)
                                    for _ in range(cfg.num_layers))
        self.reset_parameters(seed)

    def _spans(self):
        """``(lo, hi, site index or None)``: the Mamba layers lo..hi-1, then
        the shared block at that site (None after the last site)."""
        prev = 0
        for si, site in enumerate(self.sites):
            yield prev, site + 1, si
            prev = site + 1
        if prev < self.cfg.num_layers:
            yield prev, self.cfg.num_layers, None

    # ------------------------------------------------------------ forward --
    def _mamba_block(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        return x + ssm.mamba_forward(lp["m"], self.mcfg,
                                     L.rms_norm(x, lp["ln"]))

    def _site_input(self, w: dict, x: torch.Tensor, x0: torch.Tensor,
                    si: int) -> torch.Tensor:
        h = L.linear(torch.cat([x, x0], dim=-1), w["site_proj"][si])
        return L.rms_norm(h, w["shared"]["ln1"])

    def _shared_block(self, w: dict, x: torch.Tensor, x0: torch.Tensor,
                      si: int, positions: Optional[torch.Tensor]):
        sp = w["shared"]
        h = attn.full_attention(sp["attn"], self.acfg,
                                self._site_input(w, x, x0, si),
                                positions=positions)
        x = x + h
        return x + L.swiglu_apply(sp["mlp"], L.rms_norm(x, sp["ln2"]))

    def _run(self, w: dict, layers, tokens: torch.Tensor,
             positions: Optional[torch.Tensor], remat: bool) -> torch.Tensor:
        x0 = constrain(self._embed(w, tokens), "btd")
        x = x0
        for lo, hi, si in self._spans():
            for lp in layers[lo:hi]:
                x = constrain(
                    checkpoint(self._mamba_block, lp, x, use_reentrant=False)
                    if remat else self._mamba_block(lp, x), "btd")
            if si is not None:
                x = self._shared_block(w, x, x0, si, positions)
        x = L.rms_norm(x, w["final_norm"])
        return constrain(L.unembed_apply(w, x, tied=True), "btv")

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V_pad)."""
        w = self.compute_params()
        return self._run(w, w["layers"], tokens, positions, remat=False)

    def loss(self, batch: dict) -> torch.Tensor:
        return L.cross_entropy_loss(
            self.forward(batch["tokens"], positions=batch.get("positions")),
            batch["labels"], self.cfg.vocab_size)

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.forward(tokens)[:, -1:]

    # ------------------------------------------------ functional (train) --
    def apply(self, params: dict, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The reference's ``forward(params, tokens, positions)`` on its
        stacked tree, differentiable in ``params``."""
        return self._run(params, unstack_layers(params["layers"]), tokens,
                         positions, self.cfg.remat)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        return L.cross_entropy_loss(
            self.apply(params, batch["tokens"],
                       positions=batch.get("positions")),
            batch["labels"], self.cfg.vocab_size)

    # ------------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
        dev = self.embedding.device
        # float32 Mamba states whatever the compute dtype, as the
        # reference's
        return {"mamba": ssm.init_mamba_cache(batch, self.mcfg,
                                              torch.float32, dev,
                                              self.cfg.num_layers),
                "shared": attn.init_kv_cache(batch, max_len, self.acfg, dtype,
                                             dev, len(self.sites))}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    pos: torch.Tensor):
        """tokens (B, 1), pos (B,) -> (logits (B, 1, V_pad), cache), the
        cache written in place."""
        w = self.compute_params()
        x0 = self._embed(w, tokens)
        x = x0
        mc, sc = cache["mamba"], cache["shared"]
        for lo, hi, si in self._spans():
            for i in range(lo, hi):
                lp = w["layers"][i]
                x = x + ssm.mamba_decode(
                    lp["m"], self.mcfg, L.rms_norm(x, lp["ln"]),
                    {k: mc[k][i] for k in ("ssm", "conv")})
            if si is None:
                continue
            sp = w["shared"]
            h, _ = attn.decode_attention(
                sp["attn"], self.acfg, self._site_input(w, x, x0, si),
                {k: sc[k][si] for k in ("k", "v", "pos")}, pos)
            x = x + h
            x = x + L.swiglu_apply(sp["mlp"], L.rms_norm(x, sp["ln2"]))
        x = L.rms_norm(x, w["final_norm"])
        return L.unembed_apply(w, x, tied=True), cache
