"""Decoder-only transformer LM, dense family (qwen2.5 / qwen3 / smollm /
granite); counterpart of ``repro.models.transformer``.

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

As in the reference, both ignore ``cfg.norm`` and always use RMSNorm.
MoE (``num_experts > 0``) is refused: ``models/moe.py`` is not yet ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.tree import leaves, unflatten


def _attn_config(cfg: ModelConfig) -> attn.AttnConfig:
    hp, hkp = attn.padded_heads(cfg.num_heads, cfg.num_kv_heads, cfg.tp)
    return attn.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim_,
        heads_padded=hp, kv_heads_padded=hkp, qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta, causal=True,
        window=cfg.window, use_rope=cfg.use_rope,
        mrope_sections=cfg.mrope_sections)


def _param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


class Attention(nn.Module):
    def __init__(self, a: attn.AttnConfig, device):
        super().__init__()
        hp, hk, d, dm = a.heads_padded, a.kv_heads_padded, a.head_dim, a.d_model
        self.wq = _param(dm, hp, d, device=device)
        self.wk = _param(dm, hk, d, device=device)
        self.wv = _param(dm, hk, d, device=device)
        self.wo = _param(hp, d, dm, device=device)
        if a.qkv_bias:
            self.bq = _param(hp, d, device=device)
            self.bk = _param(hk, d, device=device)
            self.bv = _param(hk, d, device=device)
        if a.qk_norm:
            self.q_norm = _param(d, device=device)
            self.k_norm = _param(d, device=device)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.mlp == "swiglu":
            self.gate = _param(d, f, device=device)
            self.up = _param(d, f, device=device)
            self.down = _param(f, d, device=device)
        else:
            self.fc1 = _param(d, f, device=device)
            self.b1 = _param(f, device=device)
            self.fc2 = _param(f, d, device=device)
            self.b2 = _param(d, device=device)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, a: attn.AttnConfig, device):
        super().__init__()
        self.ln1 = _param(cfg.d_model, device=device)
        self.attn = Attention(a, device)
        self.ln2 = _param(cfg.d_model, device=device)
        self.mlp = MLP(cfg, device)


def _tree(module: nn.Module, dtype: torch.dtype) -> dict:
    """A module's parameters as the reference's nested dict, cast to
    ``dtype`` (float32 parameters are passed through, not copied)."""
    out = {name: p.detach().to(dtype)
           for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = _tree(child, dtype)
    return out


def unstack_layers(layers: dict) -> list[dict]:
    """A stacked layer tree (leaves ``(L, ...)``) as one tree a layer, each
    leaf a view of its stacked leaf (one ``unbind(0)`` a leaf: its backward
    is a single ``stack``, where ``leaf[i]`` per layer would write a whole
    ``(L, ...)`` gradient for each)."""
    views = [leaf.unbind(0) for leaf in leaves(layers)]
    return [unflatten(layers, [v[i] for v in views])
            for i in range(len(views[0]))]


class DecoderLM(nn.Module):
    """Decoder-only LM on ``device`` with random weights from ``seed``
    (truncated normal, fan-in scaled, on a ``torch.Generator`` of that
    device)."""

    def __init__(self, cfg: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.num_experts:
            raise ValueError(
                f"{cfg.name}: num_experts={cfg.num_experts} needs the MoE "
                "layer, models/moe.py, which is not yet ported")
        self.cfg = cfg
        self.acfg = _attn_config(cfg)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        v_pad = L.pad_to(cfg.vocab_size, 256)
        self.embedding = _param(v_pad, cfg.d_model, device=device)
        if not cfg.tie_embeddings:
            self.unembed = _param(v_pad, cfg.d_model, device=device)
        self.final_norm = _param(cfg.d_model, device=device)
        self.layers = nn.ModuleList(Block(cfg, self.acfg, device)
                                    for _ in range(cfg.num_layers))
        self._cast = None
        self.reset_parameters(seed)

    # ------------------------------------------------------------- params --
    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights, initialised as the reference's ``init``: norms
        one, biases zero, the embedding a truncated normal at scale 1,
        every other matrix at ``1/sqrt(shape[0])``; padded heads' ``wo``
        rows zero."""
        gen = torch.Generator(device=self.embedding.device)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv", "b1", "b2"):
                p.zero_()
            else:
                L.dense_init_(p, gen, 1.0 if leaf == "embedding" else None)
        for blk in self.layers:
            blk.attn.wo.copy_(attn.mask_padded_heads(
                {"wo": blk.attn.wo}, self.acfg)["wo"])

    def compute_params(self) -> dict:
        """The parameters as the reference's nested dict (``layers`` a list,
        one dict a layer) in the compute dtype: the module's float32
        tensors at float32 compute, else one cached cast, re-made after any
        parameter changed."""
        version = tuple(p._version for p in self.parameters())
        if self._cast is None or self._cast[0] != version:
            self._cast = None
            tree = _tree(self, self.compute_dtype)
            tree["layers"] = [tree["layers"][str(i)]
                              for i in range(self.cfg.num_layers)]
            self._cast = (version, tree)
        return self._cast[1]

    def _apply(self, fn, recurse=True):
        self._cast = None
        return super()._apply(fn, recurse)

    # ------------------------------------------------------------ forward --
    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.mlp == "swiglu":
            return L.swiglu_apply(lp["mlp"], h)
        return L.gelu_mlp_apply(lp["mlp"], h)

    def _block(self, lp: dict, x: torch.Tensor,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
        h = L.rms_norm(x, lp["ln1"])
        x = x + attn.full_attention(lp["attn"], self.acfg, h,
                                    positions=positions)
        h = L.rms_norm(x, lp["ln2"])
        return x + self._mlp(lp, h)

    def _run(self, w: dict, layers, tokens: torch.Tensor,
             positions: Optional[torch.Tensor], remat: bool):
        """Embed, the blocks (one tree a layer in ``layers``), final norm
        and unembed: (logits (B, S, V_pad), aux loss 0)."""
        x = L.embed_apply(w, tokens).to(self.compute_dtype)
        for lp in layers:
            if remat:
                x = checkpoint(self._block, lp, x, positions,
                               use_reentrant=False)
            else:
                x = self._block(lp, x, positions)
        x = L.rms_norm(x, w["final_norm"])
        logits = L.unembed_apply(w, x, tied=self.cfg.tie_embeddings)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (logits (B, S, V_pad), aux loss 0)."""
        w = self.compute_params()
        return self._run(w, w["layers"], tokens, positions, remat=False)

    def _loss(self, out, labels: torch.Tensor) -> torch.Tensor:
        logits, aux = out
        ce = L.cross_entropy_loss(logits, labels, self.cfg.vocab_size)
        return ce + 0.01 * aux

    def loss(self, batch: dict) -> torch.Tensor:
        return self._loss(self.forward(batch["tokens"],
                                       positions=batch.get("positions")),
                          batch["labels"])

    # ------------------------------------------------ functional (train) --
    def apply(self, params: dict, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None):
        """The reference's ``forward(params, tokens, positions)`` on a
        stacked parameter tree, differentiable in ``params``: tokens
        (B, S) -> (logits (B, S, V_pad), aux loss 0).  (It shadows
        ``nn.Module.apply(fn)``, which nothing calls on this module.)"""
        return self._run(params, unstack_layers(params["layers"]), tokens,
                         positions, remat=self.cfg.remat)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        """The reference's ``loss(params, batch)``: mean next-token cross
        entropy of ``apply`` (plus 0.01 x its aux loss)."""
        return self._loss(self.apply(params, batch["tokens"],
                                     positions=batch.get("positions")),
                          batch["labels"])

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
        x = L.embed_apply(w, tokens).to(self.compute_dtype)
        for i, lp in enumerate(w["layers"]):
            h = L.rms_norm(x, lp["ln1"])
            h, _ = attn.decode_attention(
                lp["attn"], self.acfg, h,
                {k: cache[k][i] for k in ("k", "v", "pos")}, pos)
            x = x + h
            h = L.rms_norm(x, lp["ln2"])
            x = x + self._mlp(lp, h)
        x = L.rms_norm(x, w["final_norm"])
        logits = L.unembed_apply(w, x, tied=self.cfg.tie_embeddings)
        return logits, cache

    def prefill(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward returning last-position logits (the
        prefill benchmark shape)."""
        logits, _ = self.forward(tokens, positions)
        return logits[:, -1:]
