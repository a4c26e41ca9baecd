"""Whisper-style encoder-decoder backbone, the audio family (counterpart of
``repro.models.encdec``).

As in the reference, the conv frontend is a stub: the batch supplies
pre-computed frame embeddings ``enc_embeds (B, S_enc, d_model)``.  The
encoder adds fixed sinusoidal positions and runs bidirectional attention;
the decoder adds learned positions (``dec_pos``, 32,768 rows), causal
self-attention and cross-attention to the encoder's output; pre-LN
LayerNorm (with bias, eps 1e-5) and GELU MLPs throughout — this file's own
``_ln``, not ``DecoderLM``'s RMSNorm.  Both stacks have ``num_layers``
layers (``enc_layers``, ``dec_layers``).

Decode: ``precompute_cross`` gives every decoder layer's cross K/V once,
stacked ``(L, B, T, Hk, D)``; ``decode_step(cache, tokens, pos, cross_kv)``
writes the self-attention KV cache in place.  ``ServeEngine`` does not
serve this family (its decode needs the encoder's output), as in the
reference; it is driven directly.
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
from repro_torch.models.module import (
    MLP, Attention, LMModule, mlp_apply, param, unstack_layers)

MAX_DEC_LEN = 4096 * 8      # learned decoder positions


def _ln(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return L.layer_norm(x, p[f"{name}_w"], p[f"{name}_b"])


def _ln_params(module: nn.Module, name: str, d: int, device) -> None:
    setattr(module, f"{name}_w", param(d, device=device))
    setattr(module, f"{name}_b", param(d, device=device))


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, a: attn.AttnConfig, device):
        super().__init__()
        _ln_params(self, "ln1", cfg.d_model, device)
        self.attn = Attention(a, device)
        _ln_params(self, "ln2", cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", device)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, a_self: attn.AttnConfig,
                 a_cross: attn.AttnConfig, device):
        super().__init__()
        _ln_params(self, "ln1", cfg.d_model, device)
        self.self_attn = Attention(a_self, device)
        _ln_params(self, "ln_x", cfg.d_model, device)
        self.cross_attn = Attention(a_cross, device)
        _ln_params(self, "ln2", cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, "gelu", device)


class EncDecLM(LMModule):
    INIT_SCALE = {"embedding": 1.0, "dec_pos": 0.01}

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__(cfg)
        hp, hkp = attn.padded_heads(cfg.num_heads, cfg.num_kv_heads, cfg.tp)
        base = dict(d_model=cfg.d_model, num_heads=cfg.num_heads,
                    num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
                    heads_padded=hp, kv_heads_padded=hkp, use_rope=False)
        self.enc_cfg = attn.AttnConfig(**base, causal=False)
        self.self_cfg = attn.AttnConfig(**base, causal=True)
        self.cross_cfg = attn.AttnConfig(**base, causal=False, cross=True)
        d = cfg.d_model
        self.embedding = param(L.pad_to(cfg.vocab_size, 256), d,
                               device=device)
        self.dec_pos = param(MAX_DEC_LEN, d, device=device)
        _ln_params(self, "enc_final", d, device)
        _ln_params(self, "dec_final", d, device)
        self.enc_layers = nn.ModuleList(
            EncBlock(cfg, self.enc_cfg, device)
            for _ in range(cfg.num_layers))
        self.dec_layers = nn.ModuleList(
            DecBlock(cfg, self.self_cfg, self.cross_cfg, device)
            for _ in range(cfg.num_layers))
        self.reset_parameters(seed)

    # ------------------------------------------------------------ encoder --
    def _enc_block(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        h = _ln(x, lp, "ln1")
        x = x + attn.full_attention(lp["attn"], self.enc_cfg, h)
        h = _ln(x, lp, "ln2")
        return x + mlp_apply(lp["mlp"], h, "gelu")

    def _encode(self, w: dict, layers, enc_embeds: torch.Tensor,
                remat: bool) -> torch.Tensor:
        s = enc_embeds.shape[1]
        x = enc_embeds.to(self.compute_dtype)
        x = x + L.sinusoidal_positions(s, self.cfg.d_model,
                                       x.device).to(x.dtype)[None]
        x = constrain(x, "btd")
        for lp in layers:
            x = constrain(
                checkpoint(self._enc_block, lp, x, use_reentrant=False)
                if remat else self._enc_block(lp, x), "btd")
        return _ln(x, w, "enc_final")

    # ------------------------------------------------------------ decoder --
    def _dec_block(self, lp: dict, x: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
        h = _ln(x, lp, "ln1")
        x = x + attn.full_attention(lp["self_attn"], self.self_cfg, h)
        h = _ln(x, lp, "ln_x")
        x = x + attn.full_attention(lp["cross_attn"], self.cross_cfg, h,
                                    x_kv=enc_out)
        h = _ln(x, lp, "ln2")
        return x + mlp_apply(lp["mlp"], h, "gelu")

    def _decode_full(self, w: dict, layers, tokens: torch.Tensor,
                     enc_out: torch.Tensor, remat: bool) -> torch.Tensor:
        s = tokens.shape[1]
        x = L.embed_apply(w, tokens).to(enc_out.dtype)
        x = constrain(x + w["dec_pos"][:s].to(x.dtype)[None], "btd")
        for lp in layers:
            x = constrain(
                checkpoint(self._dec_block, lp, x, enc_out,
                           use_reentrant=False)
                if remat else self._dec_block(lp, x, enc_out), "btd")
        x = _ln(x, w, "dec_final")
        return constrain(L.unembed_apply(w, x, tied=True), "btv")

    @torch.no_grad()
    def encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """enc_embeds (B, S_enc, d) -> the encoder's output (B, S_enc, d)."""
        w = self.compute_params()
        return self._encode(w, w["enc_layers"], enc_embeds, remat=False)

    @torch.no_grad()
    def decode_full(self, tokens: torch.Tensor,
                    enc_out: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) over enc_out -> logits (B, S, V_pad)."""
        w = self.compute_params()
        return self._decode_full(w, w["dec_layers"], tokens, enc_out,
                                 remat=False)

    def forward(self, batch: dict) -> torch.Tensor:
        """batch: ``enc_embeds (B, S_enc, d)``, ``tokens (B, S)`` ->
        logits."""
        return self.decode_full(batch["tokens"],
                                self.encode(batch["enc_embeds"]))

    def loss(self, batch: dict) -> torch.Tensor:
        return L.cross_entropy_loss(self.forward(batch), batch["labels"],
                                    self.cfg.vocab_size)

    # ------------------------------------------------ functional (train) --
    def apply(self, params: dict, batch: dict) -> torch.Tensor:
        """The reference's ``forward(params, batch)`` on its stacked tree,
        differentiable in ``params``."""
        remat = self.cfg.remat
        enc_out = self._encode(params, unstack_layers(params["enc_layers"]),
                               batch["enc_embeds"], remat)
        return self._decode_full(params, unstack_layers(params["dec_layers"]),
                                 batch["tokens"], enc_out, remat)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        return L.cross_entropy_loss(self.apply(params, batch),
                                    batch["labels"], self.cfg.vocab_size)

    # ------------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
        """The decoder's stacked (L, ...) self-attention KV cache; the
        cross K/V come from ``precompute_cross``."""
        return {"self": attn.init_kv_cache(batch, max_len, self.self_cfg,
                                           dtype, self.embedding.device,
                                           self.cfg.num_layers),
                "cross_k": None, "cross_v": None}

    @torch.no_grad()
    def precompute_cross(self, enc_out: torch.Tensor):
        """Every decoder layer's cross-attention K and V of ``enc_out``
        (position-independent, computed once): two (L, B, T, Hk, D)."""
        w = self.compute_params()
        ks = [L.linear(enc_out, lp["cross_attn"]["wk"].to(enc_out.dtype))
              for lp in w["dec_layers"]]
        vs = [L.linear(enc_out, lp["cross_attn"]["wv"].to(enc_out.dtype))
              for lp in w["dec_layers"]]
        return torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    pos: torch.Tensor, cross_kv):
        """tokens (B, 1), pos (B,), cross_kv from ``precompute_cross`` ->
        (logits (B, 1, V_pad), cache), the self-attention cache written in
        place."""
        w = self.compute_params()
        x = self._embed(w, tokens)
        # the residual stream's batch over data, as DecoderLM's: DTensor's
        # own layout of the sum leaves it over the model axis
        x = constrain(x + w["dec_pos"][pos.long()][:, None].to(x.dtype),
                      "btd")
        ck, cv = cross_kv
        sc = cache["self"]
        for i, lp in enumerate(w["dec_layers"]):
            h = _ln(x, lp, "ln1")
            h, _ = attn.decode_attention(
                lp["self_attn"], self.self_cfg, h,
                {k: sc[k][i] for k in ("k", "v", "pos")}, pos)
            x = x + h
            h = _ln(x, lp, "ln_x")
            q = L.linear(h, lp["cross_attn"]["wq"])
            x = x + attn._out_proj(lp["cross_attn"], attn.cached_attention(
                q, ck[i], cv[i], None, self.cross_cfg.head_dim))
            h = _ln(x, lp, "ln2")
            x = constrain(x + mlp_apply(lp["mlp"], h, "gelu"), "btd")
        x = _ln(x, w, "dec_final")
        return L.unembed_apply(w, x, tied=True), cache
