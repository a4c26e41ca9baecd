"""What every model family's ``nn.Module`` shares: parameters named and
laid out as the reference's tree, random initialisation drawing the
reference's distribution, and the cached compute-dtype copy the serving
methods run on.

* Parameters are float32 ``nn.Parameter``s without ``requires_grad``: the
  serving methods run without autograd, and training differentiates an
  external tree (``convert.tree_from_module``), never the module.
* ``module_tree`` gives a module's parameters as the reference's nested
  dict; an ``nn.ModuleList`` (``layers``, ``enc_layers``, ``dec_layers``,
  ``blocks``) becomes a list, one dict an entry (the reference stacks the
  first three on a leading ``(L, ...)`` axis and keeps ``blocks`` a
  tuple; ``convert.py`` maps between the two).
* ``LMModule.reset_parameters`` draws what the reference's ``init`` draws:
  norms one, biases and the SSM's ``dt_bias``, ``A_log`` and ``D`` zero,
  every other leaf a truncated normal at ``1/sqrt(shape[0])`` unless the
  leaf's module names another scale in ``INIT_SCALE`` (the embedding 1,
  ``dec_pos`` and the mLSTM's ``w_i``/``w_f`` 0.01, the sLSTM's ``r_*``
  0.1); padded heads' ``wo`` rows zero.  A module built on the meta device
  draws nothing.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.tree import leaves, unflatten

_ONES = {"ln1", "ln2", "ln", "final_norm", "q_norm", "k_norm", "norm",
         "mnorm", "gnorm"}
_ZEROS = {"bq", "bk", "bv", "b1", "b2", "dt_bias", "A_log", "D"}


def param(*shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def _init_rule(leaf: str):
    """``"ones"``, ``"zeros"`` or None (a dense draw) for a leaf name;
    LayerNorm pairs are ``<name>_w`` / ``<name>_b``, the sLSTM's biases
    ``b_<gate>``."""
    if leaf in _ONES or leaf.endswith("_w"):
        return "ones"
    if leaf in _ZEROS or leaf.endswith("_b") or leaf.startswith("b_"):
        return "zeros"
    return None


class Attention(nn.Module):
    """``wq (d, Hp, D)``, ``wk``/``wv (d, Hkp, D)``, ``wo (Hp, D, d)``
    [, ``bq``/``bk``/``bv``] [, ``q_norm``/``k_norm``]."""

    def __init__(self, a: attn.AttnConfig, device):
        super().__init__()
        self.acfg = a
        hp, hk, d, dm = a.heads_padded, a.kv_heads_padded, a.head_dim, a.d_model
        self.wq = param(dm, hp, d, device=device)
        self.wk = param(dm, hk, d, device=device)
        self.wv = param(dm, hk, d, device=device)
        self.wo = param(hp, d, dm, device=device)
        if a.qkv_bias:
            self.bq = param(hp, d, device=device)
            self.bk = param(hk, d, device=device)
            self.bv = param(hk, d, device=device)
        if a.qk_norm:
            self.q_norm = param(d, device=device)
            self.k_norm = param(d, device=device)


class MLP(nn.Module):
    """SwiGLU (``gate``, ``up``, ``down``) or GELU (``fc1``, ``b1``,
    ``fc2``, ``b2``)."""

    def __init__(self, d: int, f: int, kind: str, device):
        super().__init__()
        if kind == "swiglu":
            self.gate = param(d, f, device=device)
            self.up = param(d, f, device=device)
            self.down = param(f, d, device=device)
        else:
            self.fc1 = param(d, f, device=device)
            self.b1 = param(f, device=device)
            self.fc2 = param(f, d, device=device)
            self.b2 = param(d, device=device)


def mlp_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return L.swiglu_apply(p, x)
    return L.gelu_mlp_apply(p, x)


def module_tree(module: nn.Module, dtype: torch.dtype):
    """A module's parameters as the reference's nested dict (a
    ``ModuleList`` as a list), cast to ``dtype`` (float32 parameters are
    passed through, not copied)."""
    if isinstance(module, nn.ModuleList):
        return [module_tree(m, dtype) for m in module]
    out = {name: p.detach().to(dtype)
           for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = module_tree(child, dtype)
    return out


def unstack_layers(layers: dict) -> list[dict]:
    """A stacked layer tree (leaves ``(L, ...)``) as one tree a layer, each
    leaf a view of its stacked leaf (one ``unbind(0)`` a leaf: its backward
    is a single ``stack``, where ``leaf[i]`` per layer would write a whole
    ``(L, ...)`` gradient for each)."""
    views = [leaf.unbind(0) for leaf in leaves(layers)]
    return [unflatten(layers, [v[i] for v in views])
            for i in range(len(views[0]))]


class LMModule(nn.Module):
    """Base of the families' modules: ``self.cfg``, ``compute_dtype``, an
    ``embedding`` parameter, random weights, the cached compute-dtype copy.
    Submodules may set ``INIT_SCALE = {leaf: scale}``."""

    INIT_SCALE = {"embedding": 1.0}

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self._cast = None

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights drawn as the reference's ``init`` draws them, from
        ``seed`` on a ``torch.Generator`` of the parameters' device."""
        if self.embedding.is_meta:
            return
        gen = torch.Generator(device=self.embedding.device)
        gen.manual_seed(int(seed))
        for module in self.modules():
            scales = getattr(module, "INIT_SCALE", {})
            for leaf, p in module.named_parameters(recurse=False):
                rule = _init_rule(leaf)
                if rule == "ones":
                    p.fill_(1.0)
                elif rule == "zeros":
                    p.zero_()
                else:
                    L.dense_init_(p, gen, scales.get(leaf))
            if isinstance(module, Attention):
                module.wo.copy_(attn.mask_padded_heads(
                    {"wo": module.wo}, module.acfg)["wo"])

    def compute_params(self) -> dict:
        """The parameters as the reference's nested dict (``module_tree``)
        in the compute dtype: the module's float32 tensors at float32
        compute, else one cached cast, re-made after any parameter
        changed (tracked by the parameters' version counters)."""
        version = tuple(p._version for p in self.parameters())
        if self._cast is None or self._cast[0] != version:
            self._cast = None
            self._cast = (version, module_tree(self, self.compute_dtype))
        return self._cast[1]

    def _apply(self, fn, recurse=True):
        self._cast = None
        return super()._apply(fn, recurse)

    def _embed(self, w: dict, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed_apply(w, tokens).to(self.compute_dtype)
