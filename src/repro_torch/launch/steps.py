"""Cells: (architecture × shape × mesh) -> step function + abstract
inputs with placements (counterpart of ``repro.launch.steps``).

This is the single place that knows how every family's train / prefill /
decode step is shaped and sharded.

* A cell's arguments are abstract, :class:`ArgSpec` (shape, dtype,
  :class:`~repro_torch.distributed.sharding.NamedSharding`), the
  counterpart of ``jax.ShapeDtypeStruct``: the model is built on the
  ``meta`` device, so building a cell allocates nothing, as the
  reference's ``jax.eval_shape`` does.  :func:`materialize` makes real
  DTensors of them (random weights from a seed, tokens from a numpy
  generator, zero caches) on a mesh.
* :func:`run_cell` runs ``cell.fn`` inside ``sharding_scope(cell.mesh,
  cell.batch_axes)``: that is the part of the reference's ``lower_cell``
  that carries meaning in eager PyTorch (the activation constraints bind to
  the mesh).  It also treats the plain tensors a model makes for itself
  (positions, masks, the aux loss' zero) as replicated
  (``implicit_replication``), as a traced JAX program treats its
  constants.
* The train and prefill cells are functional in the reference's parameter
  tree (``layers`` leaves stacked on ``(L, ...)``).  The decode cells run
  the module's own serving path, whose parameters are per layer: their
  first argument is the module, with each ``nn.Parameter`` a DTensor whose
  placement drops the ``"layers"`` axis (:func:`shard_module`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config
from repro_torch.distributed.autoshard import sharding_scope
from repro_torch.distributed.sharding import (
    NamedSharding,
    ShardingRules,
    activation_sharding,
    axis_sizes,
    distribute,
    logical_to_sharding,
    map_specs,
    named,
    param_shardings,
    rules_for,
)
from repro_torch.models.convert import tree_from_module
from repro_torch.models.model_zoo import build_model
from repro_torch.models.specs import logical_specs, module_param_specs
from repro_torch.train.optimizer import AdamWConfig, OptState
from repro_torch.train.train_step import TrainState, make_train_step
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """An abstract argument: shape, dtype and layout (a tree leaf)."""
    shape: tuple
    dtype: torch.dtype
    sharding: Optional[NamedSharding] = None


class Cell(NamedTuple):
    arch: str
    shape: str
    fn: callable              # the step function
    args: tuple               # abstract args (ArgSpec trees)
    model: object             # built on the meta device
    cfg: ModelConfig
    mesh: object = None
    batch_axes: tuple = ("pod", "data")
    spec: Optional[ShapeSpec] = None


def _abstract_params(model, mesh, rules: ShardingRules):
    """(params ArgSpecs with layouts, specs, layouts) of the reference's
    tree of ``model`` (built on the meta device: nothing allocated)."""
    params = tree_from_module(model)
    specs = logical_specs(model)
    shardings = param_shardings(params, specs, rules, mesh)
    params_abs = map_specs(
        lambda ax, t, s: ArgSpec(tuple(t.shape), t.dtype, s),
        specs, params, shardings)
    return params_abs, specs, shardings


def _token_specs(cfg: ModelConfig, spec: ShapeSpec, mesh, rules):
    """Abstract train/prefill batch for each family."""
    b, s = spec.global_batch, spec.seq_len
    bs = activation_sharding(mesh, rules, b)
    toks = ArgSpec((b, s), torch.int32, bs)
    if cfg.family == "encdec":
        return {"enc_embeds": ArgSpec((b, s, cfg.d_model), torch.bfloat16,
                                      bs),
                "tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        s_vis = s // 4
        s_txt = s - s_vis
        return {"vis_embeds": ArgSpec((b, s_vis, cfg.d_model),
                                      torch.bfloat16, bs),
                "tokens": ArgSpec((b, s_txt), torch.int32, bs),
                "labels": ArgSpec((b, s_txt), torch.int32, bs),
                "positions3": ArgSpec((3, b, s), torch.int32,
                                      named(mesh, ()))}
    return {"tokens": toks, "labels": toks}


# ---------------------------------------------------------------------------
# Serve-cache layouts (family-specific leaf layouts)
# ---------------------------------------------------------------------------

def _b_ax(mesh, batch: int):
    dsize = axis_sizes(mesh).get("data", 1)
    return "data" if (batch % dsize == 0 and batch > 1) else None


def _kv_cache_shardings(cache_abs, mesh, batch):
    """Stacked attention cache {(L,B,T,H,D) k/v, (L,B,T) pos}."""
    msize = axis_sizes(mesh).get("model", 1)
    b_ax = _b_ax(mesh, batch)

    def one(t):
        if len(t.shape) == 5:
            _, _, tt, h, _ = t.shape
            if h % msize == 0 and h >= msize:
                return named(mesh, (None, b_ax, None, "model"))
            if tt % msize == 0:
                return named(mesh, (None, b_ax, "model"))
            return named(mesh, (None, b_ax))
        if len(t.shape) == 3:   # pos
            if t.shape[2] % msize == 0:
                return named(mesh, (None, b_ax, "model"))
            return named(mesh, (None, b_ax))
        return named(mesh, ())

    return tree_map(one, cache_abs)


def _mamba_cache_shardings(cache_abs, mesh, batch):
    msize = axis_sizes(mesh).get("model", 1)
    b_ax = _b_ax(mesh, batch)

    def one(t):
        if len(t.shape) == 5:  # ssm (L,B,H,P,N)
            h_ax = "model" if t.shape[2] % msize == 0 else None
            return named(mesh, (None, b_ax, h_ax))
        if len(t.shape) == 4:  # conv (L,B,K,C)
            c_ax = "model" if t.shape[3] % msize == 0 else None
            return named(mesh, (None, b_ax, None, c_ax))
        return named(mesh, ())

    return tree_map(one, cache_abs)


def _replicated_batch_shardings(cache_abs, mesh, batch):
    """xLSTM caches: leaves (B, ...) — batch over data when divisible."""
    b_ax = _b_ax(mesh, batch)
    return tree_map(lambda t: named(mesh, (b_ax,)), cache_abs)


def _cache_shardings(model, cfg, cache_abs, mesh, batch):
    if cfg.family == "xlstm":
        return _replicated_batch_shardings(cache_abs, mesh, batch)
    if cfg.family == "hybrid":
        return {"mamba": _mamba_cache_shardings(cache_abs["mamba"], mesh,
                                                batch),
                "shared": _kv_cache_shardings(cache_abs["shared"], mesh,
                                              batch)}
    if cfg.family == "encdec":
        return {"self": _kv_cache_shardings(cache_abs["self"], mesh, batch),
                "cross_k": None, "cross_v": None}
    return _kv_cache_shardings(cache_abs, mesh, batch)


def _cache_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.family == "xlstm":
        return torch.float32                  # its init_cache's default
    return (torch.float32 if cfg.compute_dtype == "float32"
            else torch.bfloat16)


def _as_spec(t: torch.Tensor, sharding) -> ArgSpec:
    return ArgSpec(tuple(t.shape), t.dtype, sharding)


def module_shardings(model: nn.Module, mesh, rules: ShardingRules) -> dict:
    """``{parameter name: layout}`` of every ``nn.Parameter`` (per-layer
    parameters: no ``"layers"`` axis)."""
    axes = module_param_specs(model)
    return {name: logical_to_sharding(tuple(p.shape), axes[name], rules,
                                      mesh)
            for name, p in model.named_parameters()}


@torch.no_grad()
def shard_module(model: nn.Module, shardings: dict) -> nn.Module:
    """Replace each ``nn.Parameter`` of ``model`` by one holding a DTensor
    of its layout in ``shardings`` (the module's values, equal on every
    rank); returns ``model``."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        setattr(owner, leaf, nn.Parameter(distribute(p.data, shardings[name]),
                                          requires_grad=False))
    model._cast = None
    return model


# ---------------------------------------------------------------------------
# Cell construction
# ---------------------------------------------------------------------------

def _prefill_fn(model, cfg):
    if cfg.family == "encdec":
        return lambda params, batch: model.apply(params, batch)[:, -1:]
    if cfg.family == "vlm":
        return lambda params, batch: model.apply(params, batch)[0][:, -1:]
    if cfg.family in ("dense", "moe"):
        return lambda params, batch: model.apply(
            params, batch["tokens"])[0][:, -1:]
    return lambda params, batch: model.apply(params, batch["tokens"])[:, -1:]


def build_cell(arch: str, shape_name, mesh,
               opt_cfg: AdamWConfig = AdamWConfig(),
               unroll_for_cost: bool = True,
               overrides: Optional[dict] = None,
               reduced: bool = False) -> Cell:
    """The cell of ``arch`` at ``shape_name`` (a name of ``SHAPES`` or a
    ``ShapeSpec``) on ``mesh``; ``reduced`` takes the family's CPU-sized
    config.  ``unroll_for_cost`` is kept for the reference's signature: the
    port's layers are never rolled into a scan, so it changes nothing.

    Decode caches (and the encoder-decoder's cross K/V) hold float32 under
    float32 compute, else bf16 as the reference's (bf16 caches under
    float32 compute would round each rank's K/V where a last-ulp
    difference can flip a bf16 rounding)."""
    del unroll_for_cost
    spec = (shape_name if isinstance(shape_name, ShapeSpec)
            else SHAPES[shape_name])
    shape_name = spec.name
    tp = axis_sizes(mesh).get("model", 1)
    cfg = get_config(arch, tp=tp, reduced=reduced)
    if shape_name != "long_500k" and cfg.family == "hybrid":
        # long_window is a long-context-serve-only adaptation
        cfg = dataclasses.replace(cfg, long_window=None)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg, device="meta")
    rules = rules_for(cfg.family)
    params_abs, _, p_shardings = _abstract_params(model, mesh, rules)
    cell = dict(mesh=mesh, batch_axes=rules.batch_axes, spec=spec)

    if spec.kind == "train":
        batch_abs = _token_specs(cfg, spec, mesh, rules)
        step = make_train_step(model.loss_fn, opt_cfg)
        rep = named(mesh, ())
        scalar = ArgSpec((), torch.int32, rep)
        # Adam moments take the parameters' layouts (FSDP scales optimizer
        # memory with the full rank count); scalars replicated
        moments = map_specs(lambda ax, a: ArgSpec(a.shape, torch.float32,
                                                  a.sharding),
                            logical_specs(model), params_abs)
        state_abs = TrainState(
            params=params_abs,
            opt=OptState(mu=moments, nu=moments, step=scalar),
            step=scalar, compress_error=None)
        return Cell(arch, shape_name, step, (state_abs, batch_abs), model,
                    cfg, **cell)

    if spec.kind == "prefill":
        batch_abs = _token_specs(cfg, spec, mesh, rules)
        batch_abs.pop("labels", None)
        return Cell(arch, shape_name, _prefill_fn(model, cfg),
                    (params_abs, batch_abs), model, cfg, **cell)

    # ---- decode: the module's serving path on its own parameters ----
    b = spec.global_batch
    cache = model.init_cache(b, spec.seq_len, dtype=_cache_dtype(cfg))
    c_shardings = _cache_shardings(model, cfg, cache, mesh, b)
    cache_in = (tree_map(_as_spec, cache, c_shardings)
                if cfg.family != "encdec" else
                {"self": tree_map(_as_spec, cache["self"],
                                  c_shardings["self"]),
                 "cross_k": None, "cross_v": None})
    module_abs = {name: _as_spec(p, s) for (name, p), s in zip(
        model.named_parameters(),
        module_shardings(model, mesh, rules).values())}
    bs = (activation_sharding(mesh, rules, b) if b > 1
          else named(mesh, ()))
    tok = ArgSpec((b, 1), torch.int32, bs)
    pos = ArgSpec((b,), torch.int32, bs)

    if cfg.family == "encdec":
        hp = model.self_cfg.kv_heads_padded
        hd = model.self_cfg.head_dim
        ckv_shape = (cfg.num_layers, b, spec.seq_len, hp, hd)
        dt = _cache_dtype(cfg)
        ckv_shard = _kv_cache_shardings(
            {"k": ArgSpec(ckv_shape, dt)}, mesh, b)["k"]
        ckv = (ArgSpec(ckv_shape, dt, ckv_shard),
               ArgSpec(ckv_shape, dt, ckv_shard))

        def decode(module, cache, tokens, pos, cross_kv):
            return module.decode_step(cache, tokens, pos, cross_kv)

        return Cell(arch, shape_name, decode,
                    (module_abs, cache_in, tok, pos, ckv), model, cfg,
                    **cell)

    def decode(module, cache, tokens, pos):
        return module.decode_step(cache, tokens, pos)

    return Cell(arch, shape_name, decode, (module_abs, cache_in, tok, pos),
                model, cfg, **cell)


def run_cell(cell: Cell, *args):
    """``cell.fn(*args)`` with the activation constraints bound to the
    cell's mesh and the step's own plain tensors taken as replicated (the
    counterpart of the reference's ``lower_cell``)."""
    if cell.mesh is None:
        return cell.fn(*args)
    from torch.distributed.tensor.experimental import implicit_replication

    with sharding_scope(cell.mesh, batch_axes=cell.batch_axes), \
            implicit_replication():
        return cell.fn(*args)


# ---------------------------------------------------------------------------
# Real arguments on a mesh
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, ArgSpec)


def _map_specs(fn, tree):
    """``fn`` over the ArgSpec leaves of a tree of dicts, lists, tuples
    and NamedTuples (None kept)."""
    if tree is None:
        return None
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    raise TypeError(f"not an argument tree: {tree!r}")


def materialize(cell: Cell, device, seed: int = 0) -> tuple:
    """Real arguments for ``cell`` on its mesh: the model's random weights
    from ``seed`` (on ``device``, equal on every rank, then each rank keeps
    its block), zero optimizer state, the model's initial caches, tokens
    and labels drawn independently from ``numpy.random.default_rng(seed)``
    (random targets: labels equal to the tokens would let a tied
    embedding predict them near-perfectly at init), normal embeddings
    from the same generator, ``build_positions3``'s M-RoPE ids, zero
    decode positions.  On the ``meta`` device the arguments are abstract:
    every leaf is an uninitialised meta tensor of its shape and layout,
    and no host array of the global batch is made (at ``prefill_32k``
    that would run to gigabytes).  Returns ``(args, model)``: the module
    built on ``device``, whose parameters a decode cell has replaced by
    DTensors."""
    model = build_model(cell.cfg, device=device, seed=seed)
    rng = np.random.default_rng(seed)
    spec = cell.spec
    abstract = torch.device(device).type == "meta"

    def data(a: ArgSpec, name: str = "") -> torch.Tensor:
        if abstract:
            t = torch.empty(a.shape, dtype=a.dtype, device="meta")
        elif a.dtype == torch.int32 and name in ("tokens", "labels"):
            t = torch.as_tensor(rng.integers(0, cell.cfg.vocab_size,
                                             a.shape), dtype=torch.int32)
        elif a.dtype.is_floating_point:
            t = torch.as_tensor(rng.standard_normal(a.shape),
                                dtype=torch.float32).to(a.dtype)
        else:
            t = torch.zeros(a.shape, dtype=a.dtype)
        return distribute(t.to(device), a.sharding)

    if spec.kind in ("train", "prefill"):
        params = tree_from_module(model)
        state_or_params = cell.args[0]
        if spec.kind == "train":
            p = map_specs(lambda ax, t, a: distribute(t, a.sharding),
                          logical_specs(model), params,
                          state_or_params.params)
            zeros = lambda tree: _map_specs(  # noqa: E731
                lambda a: distribute(torch.zeros(a.shape, dtype=a.dtype,
                                                 device=device), a.sharding),
                tree)
            first = TrainState(params=p, opt=OptState(
                mu=zeros(state_or_params.opt.mu),
                nu=zeros(state_or_params.opt.nu),
                step=zeros(state_or_params.opt.step)),
                step=zeros(state_or_params.step), compress_error=None)
        else:
            first = map_specs(lambda ax, t, a: distribute(t, a.sharding),
                              logical_specs(model), params, state_or_params)
        batch = {k: data(a, k) for k, a in sorted(cell.args[1].items())}
        if "positions3" in batch and not abstract:
            from repro_torch.models.vlm import build_positions3

            b, s = cell.args[1]["positions3"].shape[1:]
            s_vis = cell.args[1]["vis_embeds"].shape[1]
            pos3 = torch.as_tensor(build_positions3(b, s_vis, s - s_vis),
                                   device=device)
            batch["positions3"] = distribute(
                pos3, cell.args[1]["positions3"].sharding)
        return (first, batch), model

    shard_module(model, {k: a.sharding for k, a in cell.args[0].items()})
    real = model.init_cache(spec.global_batch, spec.seq_len,
                            dtype=_cache_dtype(cell.cfg))
    if cell.cfg.family == "encdec":
        real, layouts = real["self"], cell.args[1]["self"]
    else:
        layouts = cell.args[1]
    cache = tree_map(lambda t, a: distribute(t, a.sharding), real, layouts)
    if cell.cfg.family == "encdec":
        cache = {"self": cache, "cross_k": None, "cross_v": None}
    out = [model, cache, data(cell.args[2], "tokens"), data(cell.args[3])]
    if cell.cfg.family == "encdec":
        out.append(tuple(data(a) for a in cell.args[4]))
    return tuple(out), model
