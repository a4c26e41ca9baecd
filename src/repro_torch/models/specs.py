"""Logical axis names of every parameter (the reference's ``specs`` tree,
which its ``init`` returns beside the parameters; ``repro.models.layers``
lists the names).

The port's modules carry no axis names; :func:`logical_specs` derives the
reference's spec tree from a built module's structure: each parameter's
axes come from its module's class and its own name (``AXES``), the
stacked lists (``layers``, ``enc_layers``, ``dec_layers``) put the leading
``"layers"`` axis on their leaves, and ``blocks`` (xLSTM) stays a tuple of
per-block trees.  :func:`module_param_specs` gives the axes of each
``nn.Parameter`` itself, where a per-layer parameter has no layer axis.
"""

from __future__ import annotations

from torch import nn

STACKED = ("layers", "enc_layers", "dec_layers")

_ATTN = {"wq": ("embed", "q_heads", "head"),
         "wk": ("embed", "kv_heads", "head"),
         "wv": ("embed", "kv_heads", "head"),
         "wo": ("q_heads", "head", "embed"),
         "bq": ("q_heads", "head"), "bk": ("kv_heads", "head"),
         "bv": ("kv_heads", "head"),
         "q_norm": ("head",), "k_norm": ("head",)}
_MLP = {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
        "down": ("mlp", "embed"),
        "fc1": ("embed", "mlp"), "b1": ("mlp",),
        "fc2": ("mlp", "embed"), "b2": ("embed",)}
_MAMBA = {"in_z": ("embed", "mlp"), "in_x": ("embed", "mlp"),
          "in_B": ("embed", "state"), "in_C": ("embed", "state"),
          "in_dt": ("embed", "heads_ssm"), "dt_bias": ("heads_ssm",),
          "A_log": ("heads_ssm",), "D": ("heads_ssm",),
          "conv": ("conv", "mlp"), "norm": ("mlp",), "out": ("mlp", "embed")}
_MLSTM = {"ln": ("embed",), "up": ("embed", "mlp"), "up_z": ("embed", "mlp"),
          "conv": ("conv", "mlp"),
          "wq": ("mlp", "q_heads", "head"), "wk": ("mlp", "q_heads", "head"),
          "wv": ("mlp", "q_heads", "head"),
          "w_i": ("mlp", "q_heads"), "w_f": ("mlp", "q_heads"),
          "b_i": ("q_heads",), "b_f": ("q_heads",), "mnorm": ("mlp",),
          "down": ("mlp", "embed")}
_SLSTM = {"ln": ("embed",), "conv": ("conv", "embed"), "gnorm": ("mlp",),
          "proj_up": ("mlp", "mlp2"), "proj_down": ("mlp2", "embed"),
          **{f"w_{g}": ("embed", "mlp") for g in "ifzo"},
          **{f"r_{g}": ("q_heads", "head", "head") for g in "ifzo"},
          **{f"b_{g}": ("mlp",) for g in "ifzo"}}
_TOP = {"embedding": ("vocab", "embed"), "unembed": ("vocab", "embed"),
        "dec_pos": ("pos", "embed"), "site_proj": ("sites", "embed2", "embed")}

# per module class: the axes of its own parameters
AXES = {"Attention": _ATTN, "MLP": _MLP, "Mamba": _MAMBA,
        "MLSTMBlock": _MLSTM, "SLSTMBlock": _SLSTM}


def _moe_axes(cfg) -> dict:
    ax = ("experts" if cfg.num_experts % max(cfg.tp, 1) == 0
          else "experts_unsharded")
    return {"router": ("embed", "router_experts"),
            "gate": (ax, "embed", "mlp"), "up": (ax, "embed", "mlp"),
            "down": (ax, "mlp", "embed")}


def _leaf_axes(module: nn.Module, name: str, cfg) -> tuple:
    kind = type(module).__name__
    table = _moe_axes(cfg) if kind == "MoE" else AXES.get(kind, _TOP)
    if name in table:
        return table[name]
    # norms (``ln``, ``ln1``, ``final_norm``, LayerNorm ``<name>_w/_b``)
    return ("embed",)


def _module_specs(module: nn.Module, cfg):
    if isinstance(module, nn.ModuleList):
        return [_module_specs(m, cfg) for m in module]
    out = {name: _leaf_axes(module, name, cfg)
           for name, _ in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = _module_specs(child, cfg)
    return out


def _stack(tree):
    if isinstance(tree, dict):
        return {k: _stack(v) for k, v in tree.items()}
    return ("layers",) + tree


def logical_specs(model: nn.Module) -> dict:
    """The reference's spec tree for ``model`` (any family), laid out as
    ``convert.tree_from_module``'s parameter tree."""
    tree = _module_specs(model, model.cfg)
    for name, sub in tree.items():
        if name in STACKED:
            tree[name] = _stack(sub[0])
        elif isinstance(sub, list):
            tree[name] = tuple(sub)
    return tree


def module_param_specs(model: nn.Module) -> dict:
    """``{parameter name: axes}`` for every ``nn.Parameter`` of ``model``
    (a per-layer parameter's axes have no ``"layers"`` axis)."""
    out = {}
    for mod_name, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            out[key] = _leaf_axes(module, name, model.cfg)
    return out
