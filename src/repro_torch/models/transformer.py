"""Decoder-only transformer LM: dense (qwen2.5 / qwen3 / smollm / granite)
and MoE (mixtral / phi-3.5) variants, and the text backbone of the VLM;
counterpart of ``repro.models.transformer``.

An ``nn.Module`` whose parameters carry the reference's tree names and
layouts (``embedding``, ``unembed``, ``final_norm``, ``layers.<i>.ln1``,
``layers.<i>.attn.wq`` ...; the reference stacks the layer leaves on a
leading ``(L, ...)`` axis, ``models/convert.py`` slices it).  Parameters
are float32, as the reference's.

Two paths run the same block body (``_block``):

* serving (``forward``, ``loss``, ``decode_step``, ``prefill``) runs on
  the module's own parameters without autograd.  The reference casts each
  weight to the compute dtype at every use; that cast gives the same
  values every time, so the module keeps one compute-dtype copy of its
  weights and re-makes it only after a parameter changed (tracked by the
  parameters' version counters): at bf16 compute, no decode step re-casts
  the float32 weights.
* training (``apply``, ``loss_fn``) is the reference's functional
  ``forward(params, ...)``: it takes the reference's tree (float32 leaves,
  ``layers`` leaves stacked on ``(L, ...)``; ``convert.tree_from_module``
  / ``tree_from_reference``), casts each weight at its use so autograd
  reaches the float32 leaves, takes the per-layer views with one
  ``unbind(0)`` a leaf, and with ``cfg.remat`` recomputes each block in
  the backward pass (``torch.utils.checkpoint``, the reference's
  ``jax.checkpoint``).

With ``num_experts > 0`` each block's MLP is the MoE layer
(``models/moe.py``) and the forward returns the blocks' load-balancing
losses summed in float32; ``loss`` adds 0.01 of it.  As in the reference,
both paths ignore ``cfg.norm`` and always use RMSNorm.
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
from repro_torch.models import moe as moe_mod
from repro_torch.models.module import (
    MLP, Attention, LMModule, mlp_apply, param, unstack_layers)


def _attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    hp, hkp = attn.padded_heads(cfg.num_heads, cfg.num_kv_heads, cfg.tp)
    return attn.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        heads_padded=hp, kv_heads_padded=hkp, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta, causal=True,
        window=cfg.window, use_rope=cfg.use_rope,
        mrope_sections=cfg.mrope_sections)


def _moe_config(cfg: ModelConfig) -> moe_mod.MoEConfig:
    return moe_mod.MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts,
        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)


class MoE(nn.Module):
    """``router (d, E)``, ``gate``/``up (E, d, f)``, ``down (E, f, d)``."""

    def __init__(self, m: moe_mod.MoEConfig, device):
        super().__init__()
        e, d, f = m.num_experts, m.d_model, m.d_ff
        self.router = param(d, e, device=device)
        self.gate = param(e, d, f, device=device)
        self.up = param(e, d, f, device=device)
        self.down = param(e, f, d, device=device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, a: attn.AttnConfig, device):
        super().__init__()
        self.ln1 = param(cfg.d_model, device=device)
        self.attn = Attention(a, device)
        self.ln2 = param(cfg.d_model, device=device)
        if cfg.num_experts:
            self.moe = MoE(_moe_config(cfg), device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, device)


class DecoderLM(LMModule):
    """Decoder-only LM on ``device`` with random weights from ``seed``
    (truncated normal, fan-in scaled, on a ``torch.Generator`` of that
    device)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__(cfg)
        self.acfg = _attn_config(cfg)
        self.mcfg = _moe_config(cfg) if cfg.num_experts else None
        v_pad = L.pad_to(cfg.vocab_size, 256)
        self.embedding = param(v_pad, cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = param(v_pad, cfg.d_model, device=device)
        self.final_norm = param(cfg.d_model, device=device)
        self.layers = nn.ModuleList(Block(cfg, self.acfg, device)
                                    for _ in range(cfg.num_layers))
        self.reset_parameters(seed)

    # ------------------------------------------------------------ forward --
    def _ffn(self, lp: dict, h: torch.Tensor, aux: bool = True):
        """The block's MLP or MoE on ``h``: (out, float32 aux loss or
        None)."""
        if self.mcfg is None:
            return mlp_apply(lp["mlp"], h, self.cfg.mlp), None
        if aux:
            return moe_mod.moe_apply(lp["moe"], self.mcfg, h, return_aux=True)
        return moe_mod.moe_apply(lp["moe"], self.mcfg, h), None

    def _block(self, lp: dict, x: torch.Tensor,
               positions: Optional[torch.Tensor],
               positions3: Optional[torch.Tensor]):
        h = L.rms_norm(x, lp["ln1"])
        x = x + attn.full_attention(lp["attn"], self.acfg, h,
                                    positions=positions,
                                    positions3=positions3)
        h, aux = self._ffn(lp, L.rms_norm(x, lp["ln2"]))
        return x + h, aux

    def _run(self, w: dict, layers, tokens: Optional[torch.Tensor],
             positions: Optional[torch.Tensor], remat: bool,
             positions3: Optional[torch.Tensor] = None,
             inputs_embeds: Optional[torch.Tensor] = None):
        """Embed (or take ``inputs_embeds``), the blocks (one tree a layer
        in ``layers``), final norm and unembed: (logits (B, S, V_pad),
        the blocks' aux losses summed in float32)."""
        x = (L.embed_apply(w, tokens) if inputs_embeds is None
             else inputs_embeds).to(self.compute_dtype)
        x = constrain(x, "btd")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in layers:
            if remat:
                x, a = checkpoint(self._block, lp, x, positions, positions3,
                                  use_reentrant=False)
            else:
                x, a = self._block(lp, x, positions, positions3)
            x = constrain(x, "btd")
            if a is not None:
                aux = aux + a
        x = L.rms_norm(x, w["final_norm"])
        logits = L.unembed_apply(w, x, tied=self.cfg.tie_embeddings)
        return constrain(logits, "btv"), aux

    @torch.no_grad()
    def forward(self, tokens: Optional[torch.Tensor],
                positions: Optional[torch.Tensor] = None,
                positions3: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (logits (B, S, V_pad), aux loss)."""
        w = self.compute_params()
        return self._run(w, w["layers"], tokens, positions, False,
                         positions3, inputs_embeds)

    def _loss(self, out, labels: torch.Tensor) -> torch.Tensor:
        logits, aux = out
        ce = L.cross_entropy_loss(logits, labels, self.cfg.vocab_size)
        return ce + 0.01 * aux

    def loss(self, batch: dict) -> torch.Tensor:
        return self._loss(self.forward(
            batch["tokens"], positions=batch.get("positions"),
            positions3=batch.get("positions3"),
            inputs_embeds=batch.get("inputs_embeds")), batch["labels"])

    # ------------------------------------------------ functional (train) --
    def apply(self, params: dict, tokens: Optional[torch.Tensor],
              positions: Optional[torch.Tensor] = None,
              positions3: Optional[torch.Tensor] = None,
              inputs_embeds: Optional[torch.Tensor] = None):
        """The reference's ``forward(params, tokens, ...)`` on a stacked
        parameter tree, differentiable in ``params``: tokens (B, S) ->
        (logits (B, S, V_pad), aux loss).  (It shadows
        ``nn.Module.apply(fn)``, which nothing calls on this module.)"""
        return self._run(params, unstack_layers(params["layers"]), tokens,
                         positions, self.cfg.remat, positions3, inputs_embeds)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        """The reference's ``loss(params, batch)``: mean next-token cross
        entropy of ``apply`` plus 0.01 x its aux loss."""
        return self._loss(self.apply(
            params, batch["tokens"], positions=batch.get("positions"),
            positions3=batch.get("positions3"),
            inputs_embeds=batch.get("inputs_embeds")), batch["labels"])

    # ------------------------------------------------------------- decode --
    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> dict:
        """Stacked (L, ...) KV cache; layer i decodes into views of row i."""
        return attn.init_kv_cache(batch, max_len, self.acfg, dtype,
                                  self.embedding.device, self.cfg.num_layers)

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    pos: torch.Tensor):
        """tokens (B, 1), pos (B,) -> (logits (B,1,V), cache), the cache
        written in place."""
        w = self.compute_params()
        x = constrain(self._embed(w, tokens), "btd")
        for i, lp in enumerate(w["layers"]):
            h = L.rms_norm(x, lp["ln1"])
            h, _ = attn.decode_attention(
                lp["attn"], self.acfg, h,
                {k: cache[k][i] for k in ("k", "v", "pos")}, pos)
            x = x + h
            h, _ = self._ffn(lp, L.rms_norm(x, lp["ln2"]), aux=False)
            x = constrain(x + h, "btd")
        x = L.rms_norm(x, w["final_norm"])
        logits = L.unembed_apply(w, x, tied=self.cfg.tie_embeddings)
        return logits, cache

    def prefill(self, tokens: Optional[torch.Tensor],
                positions: Optional[torch.Tensor] = None,
                positions3: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward returning last-position logits (the
        prefill benchmark shape)."""
        logits, _ = self.forward(tokens, positions, positions3, inputs_embeds)
        return logits[:, -1:]
