"""Sharding rules and activation constraints of the port
(``repro_torch.distributed.sharding`` / ``autoshard``,
``repro_torch.models.specs``, the MoE group count) against the JAX
package, on the CPU, without ranks.

* For every architecture at its reduced config (model axis 1, 2 and 16),
  ``logical_specs`` of the port's module equals the spec tree the
  reference's ``init`` returns.
* On meshes ``(8,)`` data, ``(4, 2)`` data × model and ``(2, 2, 2)`` pod ×
  data × model, every parameter's placements equal the transpose of the
  reference's spec: in process through ``_spec_for_array`` (it reads only
  ``mesh.shape``, so an object holding that dict stands in for a
  ``Mesh``), and once through the reference's ``param_shardings`` on 8
  host devices (a subprocess), which also gives ``activation_sharding`` at
  batches 1, 2, 6, 8 and 256 and every family's
  decode-cache layouts (the reference's ``_cache_shardings``) and
  ``cache_sharding`` on the two meshes with a model axis (their KV
  layouts name that axis, which a data-only JAX mesh refuses), each held
  to the port's (``launch.steps.build_cell`` on the stand-in mesh).
* xlstm-125m has no sharded parameter (the reference's test asserts it).
* ``data_group_count`` equals the reference's inside and outside scopes.
* ``moe_apply`` at G = 2 (the reference's ``data_group_count``
  monkeypatched, and the port's) gives the reference's integer dispatch
  and float32 outputs.
* ``constrain`` outside a scope returns its argument and runs no aten op;
  inside a scope a plain tensor raises.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

import family_parity as fp
from repro.configs import get_config as j_config
from repro.distributed import autoshard as j_auto
from repro.distributed import sharding as j_sh
from repro.models import build_model as j_build
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_config
from repro_torch.configs.registry import ARCHS, ShapeSpec
from repro_torch.distributed import autoshard as t_auto
from repro_torch.distributed import sharding as t_sh
from repro_torch.launch import steps as t_steps
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build_model as t_build
from repro_torch.models.specs import logical_specs, module_param_specs
from repro_torch.tree import leaves

MESHES = {"data8": {"data": 8}, "data4_model2": {"data": 4, "model": 2},
          "pod2_data2_model2": {"pod": 2, "data": 2, "model": 2}}
BATCHES = (1, 2, 6, 8, 256)
DECODE = ShapeSpec("decode_small", 32, 8, "decode")


def standin(sizes: dict):
    """A mesh stand-in: ``shape`` is the axis-size dict."""
    return SimpleNamespace(shape=dict(sizes),
                           mesh_dim_names=tuple(sizes))


def transpose(spec, sizes: dict) -> tuple:
    """DTensor placements of a reference ``PartitionSpec`` (or the JSON
    list form of one): per mesh axis, ``Shard(d)`` of the tensor dim that
    names it, else ``Replicate()``."""
    out = []
    for name in sizes:
        dims = [d for d, part in enumerate(spec)
                if part == name or (isinstance(part, (tuple, list))
                                    and name in part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def _reference_specs(arch, tp):
    model = j_build(j_config(arch, reduced=True, tp=tp))
    cap = {}

    def init(k):
        p, s = model.init(k)
        cap["s"] = s
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return cap["s"], shapes


def _normalise(t):
    """Reference spec tree with lists where the port keeps lists."""
    if isinstance(t, dict):
        return {k: _normalise(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)) and not _is_axes(t):
        return type(t)(_normalise(v) for v in t)
    return t


def _paired(specs, shapes):
    flat_s = jax.tree_util.tree_flatten_with_path(specs, is_leaf=_is_axes)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(flat_s) == len(flat_p)
    return [(jax.tree_util.keystr(k), ax, tuple(p.shape))
            for (k, ax), (_, p) in zip(flat_s, flat_p)]


@pytest.mark.parametrize("tp", (1, 2, 16))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_equals_reference(arch, tp):
    specs, _ = _reference_specs(arch, tp)
    model = t_build(t_config(arch, reduced=True, tp=tp), device="meta")
    assert logical_specs(model) == _normalise(specs)
    # every module parameter's axes: the stacked leaf's without "layers"
    per_param = module_param_specs(model)
    assert len(per_param) == sum(1 for _ in model.parameters())
    for name, axes in per_param.items():
        assert "layers" not in axes, name


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_transpose_reference_spec(arch, mesh):
    sizes = MESHES[mesh]
    tp = sizes.get("model", 1)
    specs, shapes = _reference_specs(arch, tp)
    rules_j = j_sh.rules_for(j_config(arch).family)
    rules_t = t_sh.rules_for(t_config(arch).family)
    m = standin(sizes)
    sharded = 0
    for key, axes, shape in _paired(specs, shapes):
        want = j_sh._spec_for_array(shape, axes, rules_j, m)
        got = t_sh.logical_to_sharding(shape, axes, rules_t, m)
        assert tuple(got.placements) == transpose(want, sizes), key
        sharded += any(isinstance(p, Shard) for p in got.placements)
    family = t_config(arch).family
    assert (sharded == 0) == (family == "xlstm"), (arch, sharded)


def test_xlstm_replicates_every_parameter():
    model = t_build(t_config("xlstm-125m", tp=2), device="meta")
    m = standin(MESHES["data4_model2"])
    rules = t_sh.rules_for("xlstm")
    from repro_torch.models.convert import tree_from_module

    params = tree_from_module(model)
    shardings = t_sh.param_shardings(params, logical_specs(model), rules, m)
    layouts = leaves(shardings)
    assert len(layouts) == len(leaves(params)) > 0
    assert all(p == Replicate() for s in layouts for p in s.placements)


def test_size_one_mesh_axes_replicate():
    m = standin({"data": 1, "model": 2})
    got = t_sh.named(m, ("data", "model"))
    assert got.placements == (Replicate(), Shard(1))


# ---------------------------------------------------------------------------
# The reference's NamedShardings on 8 host devices (one subprocess)
# ---------------------------------------------------------------------------

_SHARD_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.registry import ARCHS
from repro.models import build_model
from repro.distributed.sharding import (activation_sharding, cache_sharding,
                                        param_shardings, rules_for)
from repro.launch.steps import _cache_shardings

MESHES = json.loads(sys.argv[1])
BATCHES = json.loads(sys.argv[2])
B, T = json.loads(sys.argv[3])

def spec(s):
    return [list(p) if isinstance(p, tuple) else p for p in s.spec]

def tree_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)[0]
    return {jax.tree_util.keystr(k): (None if v is None else spec(v))
            for k, v in flat}

out = {}
for name, sizes in MESHES.items():
    mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes))
    tp = sizes.get("model", 1)
    rec = out[name] = {"params": {}, "act": {}, "cache": {}, "kv": {}}
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True, tp=tp)
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, long_window=None)
        model = build_model(cfg)
        cap = {}
        def init(k):
            p, s = model.init(k)
            cap["s"] = s
            return p
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
        rec["params"][arch] = tree_specs(
            param_shardings(shapes, cap["s"], rules_for(cfg.family), mesh))
        if "model" in sizes:   # its KV layouts name the model axis
            cache = jax.eval_shape(lambda: model.init_cache(B, T))
            rec["cache"][arch] = tree_specs(
                _cache_shardings(model, cfg, cache, mesh, B))
    for fam in ("dense", "xlstm"):
        trailing = ((None, "model") if fam == "dense" and "model" in sizes
                    else (None,))
        rec["act"][fam] = {str(b): spec(activation_sharding(
            mesh, rules_for(fam), b, *trailing)) for b in BATCHES}
    cases = [((2, 8, 16, 4, 32), 1, 2, 3, 8), ((2, 8, 16, 1, 32), 1, 2, 3, 8),
             ((2, 8, 15, 1, 32), 1, 2, 3, 8), ((2, 1, 16, 4, 32), 1, 2, 3, 1),
             ((2, 8, 4, 64, 16), 1, None, 2, 8)]
    rec["kv"] = ([spec(cache_sharding(mesh, *c)) for c in cases]
                 if "model" in sizes else [])
print(json.dumps(out))
"""

_KV_CASES = [((2, 8, 16, 4, 32), 1, 2, 3, 8), ((2, 8, 16, 1, 32), 1, 2, 3, 8),
             ((2, 8, 15, 1, 32), 1, 2, 3, 8), ((2, 1, 16, 4, 32), 1, 2, 3, 1),
             ((2, 8, 4, 64, 16), 1, None, 2, 8)]


@pytest.fixture(scope="module")
def reference_layouts():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _SHARD_SCRIPT, json.dumps(MESHES),
         json.dumps(BATCHES), json.dumps([DECODE.global_batch,
                                          DECODE.seq_len])],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _keyed(tree) -> dict:
    """The port's layout tree keyed as ``jax.tree_util.keystr`` keys it."""
    from repro_torch.tree import leaves_with_paths

    def key(path):
        return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                       for k in path)

    return {key(p): v for p, v in leaves_with_paths(tree)}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference_on_devices(reference_layouts, arch,
                                                    mesh):
    sizes = MESHES[mesh]
    want = reference_layouts[mesh]["params"][arch]
    m = standin(sizes)
    cell = t_steps.build_cell(arch, "train_4k", m, reduced=True)
    got = {k: a.sharding for k, a in _keyed(cell.args[0].params).items()}
    assert set(got) == set(want)
    for k, spec in want.items():
        assert tuple(got[k].placements) == transpose(spec, sizes), k
    # Adam moments take the parameters' layouts, scalars replicated
    for tree in (cell.args[0].opt.mu, cell.args[0].opt.nu):
        assert {k: a.sharding for k, a in _keyed(tree).items()} == got
    assert all(p == Replicate()
               for p in cell.args[0].opt.step.sharding.placements)


@pytest.mark.parametrize("mesh", MESHES)
def test_activation_and_cache_sharding_match_reference(reference_layouts,
                                                       mesh):
    sizes = MESHES[mesh]
    m = standin(sizes)
    ref = reference_layouts[mesh]
    for fam, by_batch in ref["act"].items():
        trailing = ((None, "model") if fam == "dense" and "model" in sizes
                    else (None,))
        for b in BATCHES:
            got = t_sh.activation_sharding(m, t_sh.rules_for(fam), b,
                                           *trailing)
            assert tuple(got.placements) == transpose(by_batch[str(b)],
                                                      sizes), (fam, b)
    assert len(ref["kv"]) == (len(_KV_CASES) if "model" in sizes else 0)
    for case, spec in zip(_KV_CASES, ref["kv"]):
        got = t_sh.cache_sharding(m, *case)
        assert tuple(got.placements) == transpose(spec, sizes), case


@pytest.mark.parametrize("mesh", [m for m in MESHES
                                  if "model" in MESHES[m]])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_layouts_match_reference(reference_layouts, arch, mesh):
    sizes = MESHES[mesh]
    want = reference_layouts[mesh]["cache"][arch]
    cell = t_steps.build_cell(arch, DECODE, standin(sizes), reduced=True)
    cache = cell.args[1]
    got = _keyed(cache)
    want = {k: v for k, v in want.items() if v is not None}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, spec in want.items():
        assert tuple(got[k].sharding.placements) == transpose(spec, sizes), k
    # the module's own parameters: the stacked layouts without "layers"
    params = {k: a.sharding for k, a in cell.args[0].items()}
    axes = module_param_specs(cell.model)
    for name, layout in params.items():
        assert layout.placements == t_sh.logical_to_sharding(
            cell.args[0][name].shape, axes[name],
            t_sh.rules_for(cell.cfg.family), standin(sizes)).placements


# ---------------------------------------------------------------------------
# Activation constraints and the MoE group count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
def test_data_group_count_matches_reference(mesh):
    m = standin(MESHES[mesh])
    assert t_auto.data_group_count(48) == j_auto.data_group_count(48) == 1
    for axes in (("pod", "data"), ("pod", "data", "model"), ("data",)):
        with j_auto.sharding_scope(m, batch_axes=axes), \
                t_auto.sharding_scope(m, batch_axes=axes):
            for tokens in (1, 2, 3, 6, 8, 12, 16, 24, 256, 4096):
                assert (t_auto.data_group_count(tokens)
                        == j_auto.data_group_count(tokens)), (axes, tokens)


@pytest.mark.parametrize("mesh", MESHES)
def test_constraint_specs_match_reference(mesh, monkeypatch):
    """The spec each kind asks for equals the one the reference hands
    ``with_sharding_constraint``."""
    sizes = MESHES[mesh]
    m = standin(sizes)
    seen = []
    monkeypatch.setattr(j_auto.jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    monkeypatch.setattr(j_auto, "NamedSharding",
                        lambda mesh_, spec: SimpleNamespace(spec=spec))
    shapes = {"btd": (8, 4, 16), "btv": (6, 4, 512), "bd": (2, 16),
              "ecd": (4, 8, 16), "gecd": (8, 4, 8, 16)}
    for axes in (("pod", "data"), ("pod", "data", "model")):
        with j_auto.sharding_scope(m, batch_axes=axes):
            for kind, shape in shapes.items():
                if "model" in axes and kind in ("btv", "gecd"):
                    continue     # the model axis would shard two dims
                j_auto.constrain(jnp.zeros(shape), kind)
                want = seen[-1].spec
                got = t_auto.constraint_spec(shape, kind, sizes, axes)
                assert t_sh.placements(got, m) == transpose(want, sizes), \
                    (axes, kind)


def test_constrain_outside_scope_is_free():
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    x = torch.randn(2, 3, 4)
    with Count():
        for kind in ("btd", "btv", "bd", "ecd", "gecd"):
            assert t_auto.constrain(x, kind) is x
    assert Count.n == 0
    with t_auto.sharding_scope(standin({"data": 2})):
        with pytest.raises(TypeError, match="plain"):
            t_auto.constrain(x, "btd")


def _reference_grouped_dispatch(monkeypatch, mcfg, p, x, groups):
    calls = []

    class Spy:
        def __getattr__(self, name):
            return getattr(jax, name)

        def vmap(self, fn, *a, **k):
            real = jax.vmap(fn, *a, **k)

            def run(*args):
                if fn.__name__ == "_scatter_group":
                    calls.append((np.asarray(args[1]), np.asarray(args[2])))
                return real(*args)
            return run

    with monkeypatch.context() as mp:
        mp.setattr(jmoe, "jax", Spy())
        mp.setattr(j_auto, "data_group_count", lambda t: groups)
        out, aux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), mcfg,
                                  jnp.asarray(x), return_aux=True)
    return calls, np.asarray(out), float(aux)


@pytest.mark.parametrize("case", ["drops", "plain"])
@pytest.mark.parametrize("arch", ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b"))
def test_moe_grouped_dispatch_equals_reference(monkeypatch, arch, case):
    groups = 2
    jc, _ = fp.configs(arch)
    mcfg = jmoe.MoEConfig(d_model=jc.d_model, d_ff=jc.d_ff,
                          num_experts=jc.num_experts, top_k=jc.top_k,
                          capacity_factor=jc.capacity_factor)
    from repro.models.layers import ParamCollector

    col = ParamCollector(jax.random.PRNGKey(5))
    jmoe.moe_init(col, mcfg)
    p = fp.np_tree(col.done()[0])
    x = np.random.default_rng(5).normal(size=(2, 32, jc.d_model))
    if case == "drops":
        x = x + 6.0 * p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    x = x.astype(np.float32)
    calls, jout, jaux = _reference_grouped_dispatch(monkeypatch, mcfg, p, x,
                                                    groups)
    tcfg = tmoe.MoEConfig(**{f: getattr(mcfg, f) for f in (
        "d_model", "d_ff", "num_experts", "top_k", "capacity_factor")})
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    tx = torch.as_tensor(x)
    tg = tx.reshape(groups, -1, tcfg.d_model)
    probs = torch.softmax(torch.matmul(tg, tp["router"]), dim=-1)
    cap = tmoe.capacity(tcfg, tg.shape[1])
    _, ids, pos, keep = tmoe.moe_dispatch(probs, tcfg.top_k, cap)
    assert len(calls) == tcfg.top_k
    for slot, (jids, jpos) in enumerate(calls):
        assert jids.shape == (groups, tg.shape[1])
        assert np.array_equal(ids[..., slot].numpy(), jids)
        assert np.array_equal(pos[..., slot].numpy(), jpos)
    if case == "drops":
        assert (~keep).sum() > 0
    monkeypatch.setattr(tmoe, "data_group_count", lambda t: groups)
    tout, taux = tmoe.moe_apply(tp, tcfg, tx, return_aux=True)
    fp.close(tout, jout, fp.F32)
    assert float(taux) == pytest.approx(jaux, rel=1e-6)
