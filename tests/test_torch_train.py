"""Port parity: the training plane (``repro_torch.train``,
``repro_torch.distributed``, ``DecoderLM``'s functional path) against the
JAX package, on the CPU.  Inputs come from numpy seeds; each tolerance is
stated where it is used.

* ``lr_at`` over a schedule's steps against the reference's (eager) within
  2 float32 ulps plus what one ulp of the cosine moves the rate: the
  reference's cosine is not correctly rounded on some angles, the port's
  is, and ``1 + cos`` magnifies one ulp of it to 2-4 ulps of the rate.
* ``adamw_update`` on a random tree, clipping active and inactive:
  parameters, moments, ``grad_norm`` and ``lr`` within a relative 1e-6,
  for one step and for two in a row.  It updates in place (the
  reference's donation): every parameter, moment and the step count keep
  their storages, and their values are the out-of-place formula's
  (written out in the test) bit for bit.
* The quadratic bowl: 300 steps equal the reference's eager steps bit for
  bit and converge (atol 0.05, the reference's own test).
* Carried smollm-135m (reduced) weights: at float32 compute, loss within a
  relative 1e-5, each gradient leaf within 1e-5 · max|ref| of
  ``jax.grad(model.loss)``, one step's moments within 1e-5 · max|ref| and
  its parameters within 1e-5 · max|ref| where ``|g_ref| > 1e-3 ·
  max|g_ref|`` and within 2·lr elsewhere (the first Adam step is
  sign-SGD: a near-zero gradient may move a parameter by ±lr in either
  package).  At bf16 compute, loss within a relative 1e-2 and
  ``grad_norm`` within 2e-2.
* ``accum_steps=2`` against ``accum_steps=1`` (loss 1e-4, ``grad_norm``
  1e-3 relative: float32 sums in another order) and against the
  reference's ``accum_steps=2`` (1e-5 relative).
* ``remat`` on gives the bits of remat off; every gradient leaf is
  non-zero, also after the serving path cached its compute-dtype copy.
* The compressors equal the reference's on the same inputs (outputs and
  residuals within 1e-6 · max|ref|); error feedback and top-k sparsity
  hold; a train step with each compressor matches the reference's.
* ``best_mesh_shape``, ``preserved_global_batch`` and ``rebalance_accum``
  equal the reference's on a grid.
* Checkpoints: round trip, prune/latest, a torn ``step_N`` ignored, and a
  checkpoint written by either package restores in the other, key for key
  and value for value.
"""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.distributed import compression as jcomp
from repro.distributed import fault as jfault
from repro.models import build_model as j_build
from repro.train import checkpoint as jckpt
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import OptState as JOptState
from repro.train.optimizer import adamw_update as j_update
from repro.train.optimizer import lr_at as j_lr
from repro.train.train_step import init_train_state as j_init_state
from repro.train.train_step import make_train_step as j_make_step
from repro_torch import distributed as tdist
from repro_torch.configs import get_config as t_config
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import (
    load_reference_params, tree_from_module, tree_from_reference)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.optimizer import OptState
from repro_torch.train.optimizer import adamw_update, lr_at
from repro_torch.train.train_step import (
    init_train_state, make_train_step, value_and_grad)
from repro_torch.tree import leaves, leaves_with_paths, tree_map

SCHEDULES = [dict(lr=1.0, warmup_steps=10, total_steps=100,
                  min_lr_ratio=0.1),
             dict(lr=0.1, warmup_steps=0, total_steps=400),
             dict(lr=3e-4, warmup_steps=100, total_steps=10_000)]


def _np(tree):
    """A tree of tensors or JAX arrays as float64 numpy leaves in the
    reference's leaf order."""
    flat = leaves(tree) if _is_torch(tree) else jax.tree.leaves(tree)
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                       np.float64) for x in flat]


def _is_torch(tree):
    flat = leaves(tree)
    return bool(flat) and isinstance(flat[0], torch.Tensor)


def _rel(got, want):
    """max |got - want| / max |want| over each leaf pair; the worst."""
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(_np(got), _np(want)))


def _t(tree):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)), tree)


def _random_tree(rng, scale=1.0):
    return {"b": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
            "a": {"y": (rng.normal(size=5) * scale).astype(np.float32),
                  "x": (rng.normal(size=(2, 2, 3)) * scale)
                  .astype(np.float32)},
            "c": [(rng.normal(size=7) * scale).astype(np.float32)]}


# ---------------------------------------------------------------------------
# pytree helper
# ---------------------------------------------------------------------------

def test_tree_leaf_order_is_the_references():
    tree = _random_tree(np.random.default_rng(0))
    assert [p for p, _ in leaves_with_paths(tree)] == [
        ("a", "x"), ("a", "y"), ("b",), ("c", 0)]
    want = jax.tree.leaves(tree)
    assert all(g is w for g, w in zip(leaves(tree), want))
    doubled = tree_map(lambda a, b: a + b, tree, tree)
    assert np.array_equal(doubled["c"][0], 2 * tree["c"][0])
    with pytest.raises(ValueError, match="leaf counts"):
        tree_map(lambda a, b: a, tree, {"a": 1})


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", SCHEDULES)
def test_lr_schedule_matches_reference(sched):
    steps = np.arange(sched["total_steps"] + 1)
    jcfg, tcfg = JAdamW(**sched), AdamWConfig(**sched)
    want = np.asarray(j_lr(jcfg, jnp.asarray(steps)))
    got = lr_at(tcfg, torch.as_tensor(steps)).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want))
    # one ulp of a cosine in [0.5, 1), through ``lr * (1 - r) * 0.5 * c``
    cos_ulp = (tcfg.lr * (1 - tcfg.min_lr_ratio) * 0.5
               * np.spacing(np.float32(0.5)))
    diff = np.abs(got.astype(np.float64) - want)
    assert (diff <= 2 * ulp + cos_ulp).all(), (diff / ulp).max()
    # the reference's own spot checks
    if sched["total_steps"] == 100:
        assert float(lr_at(tcfg, 5)) == pytest.approx(0.5)
        assert float(lr_at(tcfg, 10)) == pytest.approx(1.0, rel=1e-3)
        assert float(lr_at(tcfg, 100)) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("gscale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(gscale):
    rng = np.random.default_rng(1)
    params = _random_tree(rng)
    grads = _random_tree(rng, gscale)
    mu = _random_tree(rng, 0.1)
    nu = jax.tree.map(np.abs, _random_tree(rng, 0.1))
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=50)
    jp, jo, jm = j_update(JAdamW(**cfg), params, grads,
                          JOptState(mu=mu, nu=nu, step=jnp.asarray(5)))
    tp, to, tm = adamw_update(
        AdamWConfig(**cfg), _t(params), _t(grads),
        OptState(mu=_t(mu), nu=_t(nu), step=torch.tensor(5,
                                                         dtype=torch.int32)))
    clipped = float(jm["grad_norm"]) > 1.0
    assert clipped == (gscale > 1)
    for got, want in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
        assert _rel(got, want) <= 1e-6
    assert int(to.step) == 6
    for k in ("grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


@pytest.mark.parametrize("gscale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_is_in_place_and_the_formula_bit_for_bit(gscale):
    rng = np.random.default_rng(11)
    params, grads = _t(_random_tree(rng)), _t(_random_tree(rng, gscale))
    mu = _t(_random_tree(rng, 0.1))
    nu = tree_map(torch.abs, _t(_random_tree(rng, 0.1)))
    step0 = torch.tensor(5, dtype=torch.int32)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=50)
    # the out-of-place update, written out
    g2 = sum(torch.sum(torch.square(g)) for g in leaves(grads))
    gnorm = torch.sqrt(g2)
    scale = torch.clamp(torch.tensor(cfg.clip_norm) / torch.clamp(
        gnorm, min=1e-9), max=1.0)
    step = step0 + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    want = {"p": [], "m": [], "v": []}
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(mu),
                          leaves(nu)):
        g = g * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        want["m"].append(m2)
        want["v"].append(v2)
        want["p"].append(p - lr * ((m2 / b1c) / (torch.sqrt(v2 / b2c)
                                                 + cfg.eps)
                                   + cfg.weight_decay * p))
    before = [t.data_ptr() for t in leaves((params, mu, nu, step0))]
    new_p, opt, metrics = adamw_update(cfg, params, grads,
                                       OptState(mu=mu, nu=nu, step=step0))
    assert [t.data_ptr() for t in leaves((new_p, opt.mu, opt.nu,
                                          opt.step))] == before
    assert new_p is params and opt.mu is mu and opt.nu is nu
    assert int(step0) == 6 and opt.step is step0
    for got, key in ((params, "p"), (mu, "m"), (nu, "v")):
        for a, b in zip(leaves(got), want[key]):
            assert torch.equal(a, b), key
    assert torch.equal(metrics["grad_norm"], gnorm)
    assert torch.equal(metrics["lr"], lr)


def test_two_adamw_updates_match_reference():
    """Two updates in a row from the same seeded leaves, each with its own
    gradients, the port's in place: within a relative 1e-6 after each."""
    rng = np.random.default_rng(12)
    params = _random_tree(rng)
    grads = [_random_tree(rng, 0.5), _random_tree(rng, 3.0)]
    mu = _random_tree(rng, 0.1)
    nu = jax.tree.map(np.abs, _random_tree(rng, 0.1))
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=20)
    jstate = (params, JOptState(mu=mu, nu=nu, step=jnp.asarray(0)))
    tparams = _t(params)
    topt = OptState(mu=_t(mu), nu=_t(nu),
                    step=torch.tensor(0, dtype=torch.int32))
    for g in grads:
        jp, jo, jm = j_update(JAdamW(**cfg), *jstate[:1], g, jstate[1])
        jstate = (jp, jo)
        tp, to, tm = adamw_update(AdamWConfig(**cfg), tparams, _t(g), topt)
        assert tp is tparams and to.mu is topt.mu
        for got, want in ((tp, jp), (to.mu, jo.mu), (to.nu, jo.nu)):
            assert _rel(got, want) <= 1e-6
        assert int(to.step) == int(jo.step)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)


def _bowl(torch_side: bool):
    target = np.asarray([1.0, -2.0, 3.0], np.float32)
    if torch_side:
        t = torch.as_tensor(target)
        return (lambda p, b: torch.sum((p["w"] - t) ** 2) * b["scale"],
                {"w": torch.zeros(3)}, {"scale": torch.tensor(1.0)}, target)
    return (lambda p, b: jnp.sum((p["w"] - target) ** 2) * b["scale"],
            {"w": jnp.zeros(3)}, {"scale": jnp.asarray(1.0)}, target)


def test_quadratic_bowl_matches_reference_trajectory():
    """300 steps of the reference's quadratic bowl; the reference's step
    run eagerly (under ``jit`` XLA turns divisions by constants into
    products with reciprocals, which moves the schedule by a few ulps)."""
    kw = dict(lr=0.1, warmup_steps=0, total_steps=400, weight_decay=0.0)
    jloss, jparams, jbatch, target = _bowl(False)
    tloss, tparams, tbatch, _ = _bowl(True)
    jstep = j_make_step(jloss, JAdamW(**kw))
    tstep = make_train_step(tloss, AdamWConfig(**kw))
    js, ts = j_init_state(jparams), init_train_state(tparams)
    for _ in range(300):
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, tbatch)
        assert np.array_equal(ts.params["w"].numpy(),
                              np.asarray(js.params["w"]))
        assert float(tm["loss"]) == float(jm["loss"])
    np.testing.assert_allclose(ts.params["w"].numpy(), target, atol=0.05)
    assert int(ts.step) == int(ts.opt.step) == 300


# ---------------------------------------------------------------------------
# the model's functional path
# ---------------------------------------------------------------------------

def _carried(dtype="float32", **overrides):
    jc = dataclasses.replace(j_config("smollm-135m", reduced=True),
                             compute_dtype=dtype, **overrides)
    tc = dataclasses.replace(t_config("smollm-135m", reduced=True),
                             compute_dtype=dtype, **overrides)
    jm = j_build(jc)
    params, _ = jm.init(jax.random.PRNGKey(1))
    tm = t_build(tc, device="cpu", seed=5)
    return jm, params, tm, tree_from_reference(
        jax.tree.map(np.asarray, params), "cpu")


def _batch(cfg, shape=(4, 32), seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)})


def test_carried_weights_float32_loss_grads_and_step():
    jm, params, tm, tree = _carried("float32")
    jb, tb = _batch(tm.cfg)
    jl, jg = jax.value_and_grad(jm.loss)(params, jb)
    tl, tg = value_and_grad(tm.loss_fn, tree, tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert [p for p, _ in leaves_with_paths(tg)] == [
        tuple(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for g, w in zip(_np(tg), _np(jg)):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()

    ocfg = dict(lr=1e-3, warmup_steps=0)
    js, jmet = jax.jit(j_make_step(jm.loss, JAdamW(**ocfg)))(
        j_init_state(params), jb)
    ts, tmet = make_train_step(tm.loss_fn, AdamWConfig(**ocfg))(
        init_train_state(tree), tb)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-5)
    for got, want in zip(_np(ts.opt.mu) + _np(ts.opt.nu),
                         _np(js.opt.mu) + _np(js.opt.nu)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    lr = float(jmet["lr"])
    for got, want, p0, g in zip(_np(ts.params), _np(js.params),
                                _np(params), _np(jg)):
        steady = np.abs(g) > 1e-3 * np.abs(g).max()
        d = np.abs(got - want)
        assert d[steady].max(initial=0) <= 1e-5 * np.abs(want).max()
        assert d[~steady].max(initial=0) <= 2 * lr
        assert np.abs(got - p0).max() > 0


def test_carried_weights_bf16_loss_and_grad_norm():
    jm, params, tm, tree = _carried("bfloat16")
    jb, tb = _batch(tm.cfg)
    jl, jg = jax.value_and_grad(jm.loss)(params, jb)
    tl, tg = value_and_grad(tm.loss_fn, tree, tb)
    assert tl.dtype == torch.float32
    assert float(tl) == pytest.approx(float(jl), rel=1e-2)
    jn = float(np.sqrt(sum((g ** 2).sum() for g in _np(jg))))
    tn = float(np.sqrt(sum((g ** 2).sum() for g in _np(tg))))
    assert tn == pytest.approx(jn, rel=2e-2)
    assert all(leaf.dtype == torch.float32 for leaf in leaves(tg))


def test_grad_accumulation_matches_single_step_and_reference():
    jm, params, tm, tree = _carried("float32")
    jb, tb = _batch(tm.cfg)
    ocfg = dict(lr=1e-3, warmup_steps=0)
    # the step is donated (it updates its state in place): each run starts
    # from its own copy of the weights
    s1, m1 = make_train_step(tm.loss_fn, AdamWConfig(**ocfg))(
        init_train_state(tree_map(torch.clone, tree)), tb)
    s2, m2 = make_train_step(tm.loss_fn, AdamWConfig(**ocfg),
                             accum_steps=2)(init_train_state(tree), tb)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-4)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-3)
    js, jmet = jax.jit(j_make_step(jm.loss, JAdamW(**ocfg), accum_steps=2))(
        j_init_state(params), jb)
    for k in ("loss", "grad_norm"):
        assert float(m2[k]) == pytest.approx(float(jmet[k]), rel=1e-5)
    for got, want in zip(_np(s2.opt.mu) + _np(s2.opt.nu),
                         _np(js.opt.mu) + _np(js.opt.nu)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_remat_gives_the_bits_of_no_remat():
    cfg = dataclasses.replace(t_config("smollm-135m", reduced=True),
                              compute_dtype="float32")
    tree = tree_from_module(t_build(cfg, device="cpu", seed=2))
    _, tb = _batch(cfg, seed=3)
    out = []
    for remat in (False, True):
        tm = t_build(dataclasses.replace(cfg, remat=remat), device="cpu")
        out.append(value_and_grad(tm.loss_fn, tree, tb))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_gradient_leaf_is_nonzero(dtype):
    """Autograd reaches every float32 leaf, also after the serving path
    made and cached its compute-dtype copy of the module's weights."""
    cfg = dataclasses.replace(t_config("smollm-135m", reduced=True),
                              compute_dtype=dtype)
    tm = t_build(cfg, device="cpu", seed=4)
    _, tb = _batch(cfg, seed=5)
    tm.loss(tb)                         # the serving path's cached cast
    tree = tree_from_module(tm)
    loss, grads = value_and_grad(tm.loss_fn, tree, tb)
    assert torch.isfinite(loss)
    for path, g in leaves_with_paths(grads):
        assert g.dtype == torch.float32 and g.abs().max() > 0, path
    # the serving loss on the same weights is the functional loss
    assert float(tm.loss(tb)) == pytest.approx(float(loss), rel=1e-6)


def test_trained_tree_loads_into_a_serving_model():
    cfg = dataclasses.replace(t_config("smollm-135m", reduced=True),
                              compute_dtype="float32")
    src = t_build(cfg, device="cpu", seed=6)
    _, tb = _batch(cfg, seed=7)
    state, _ = make_train_step(src.loss_fn, AdamWConfig(warmup_steps=0))(
        init_train_state(tree_from_module(src)), tb)
    serve = t_build(cfg, device="cpu", seed=8)
    load_reference_params(serve, state.params)
    assert torch.equal(serve.layers[1].mlp.up, state.params["layers"]["mlp"]
                       ["up"][1])
    want = src.loss_fn(state.params, tb)
    assert float(serve.loss(tb)) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["int8", "topk"])
def test_compressor_matches_reference(name):
    rng = np.random.default_rng(2)
    grads = _random_tree(rng)
    grads["big"] = rng.normal(size=(40, 50)).astype(np.float32)
    err = _random_tree(rng, 0.01)
    err["big"] = (rng.normal(size=(40, 50)) * 0.01).astype(np.float32)
    jout = jcomp.get_compressor(name)(grads, err)
    tout = tdist.get_compressor(name)(_t(grads), _t(err))
    for got, want in zip(tout, jout):
        for g, w in zip(_np(got), _np(want)):
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    if name == "topk":
        for g, w in zip(_np(tout[0]), _np(jout[0])):
            assert np.array_equal(g != 0, w != 0)


def test_int8_compressor_error_feedback():
    g = {"w": torch.as_tensor(np.linspace(-1, 1, 1000), dtype=torch.float32)}
    e = tree_map(torch.zeros_like, g)
    total = torch.zeros_like(g["w"])
    for _ in range(50):
        out, e = tdist.int8_compressor(g, e)
        total = total + out["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(),
                               atol=2e-3)


def test_topk_compressor_sparsity():
    g = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=2000),
                              dtype=torch.float32)}
    e = tree_map(torch.zeros_like, g)
    out, e2 = tdist.topk_compressor(g, e, frac=0.01)
    assert int((out["w"] != 0).sum()) <= 0.02 * 2000
    np.testing.assert_allclose((out["w"] + e2["w"]).numpy(),
                               g["w"].numpy(), atol=1e-6)
    ties = {"w": torch.ones(10)}
    kept, _ = tdist.topk_compressor(ties, tree_map(torch.zeros_like, ties),
                                    frac=0.1)
    assert torch.equal(kept["w"], ties["w"])     # >= keeps every tie


@pytest.mark.parametrize("name", ["int8", "topk"])
def test_train_step_with_compressor_matches_reference(name):
    jloss, jparams, jbatch, _ = _bowl(False)
    tloss, tparams, tbatch, _ = _bowl(True)
    kw = dict(lr=0.1, warmup_steps=0, total_steps=100, weight_decay=0.0)
    jstep = j_make_step(jloss, JAdamW(**kw),
                        compressor=jcomp.get_compressor(name))
    tstep = make_train_step(tloss, AdamWConfig(**kw),
                            compressor=tdist.get_compressor(name))
    js = j_init_state(jparams, compress=True)
    ts = init_train_state(tparams, compress=True)
    for _ in range(5):
        js, _ = jstep(js, jbatch)
        ts, _ = tstep(ts, tbatch)
    for got, want in ((ts.params, js.params),
                      (ts.compress_error, js.compress_error)):
        for g, w in zip(_np(got), _np(want)):
            assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1.0)


# ---------------------------------------------------------------------------
# fault tolerance helpers
# ---------------------------------------------------------------------------

def test_fault_helpers_match_reference():
    for n, model, pod in itertools.product(
            (1, 2, 3, 4, 8, 17, 240, 256, 384, 512), (1, 2, 4, 16), (1, 2)):
        try:
            want = jfault.best_mesh_shape(n, model, pod_axis=pod)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                tdist.best_mesh_shape(n, model, pod_axis=pod)
            continue
        assert tdist.best_mesh_shape(n, model, pod_axis=pod) == want
    for gb, old, new in itertools.product((7, 64, 256), (4, 12, 16),
                                          (1, 3, 12, 16)):
        assert tdist.preserved_global_batch(gb, old, new) == \
            jfault.preserved_global_batch(gb, old, new)
    rng = np.random.default_rng(3)
    for base in (1, 2, 4, 8):
        times = rng.uniform(0.5, 3.0, size=6)
        assert np.array_equal(tdist.rebalance_accum(times, base),
                              jfault.rebalance_accum(times, base))
    inj = tdist.FailureInjector(fail_at_steps=(3,), kill_devices=2)
    assert [inj.check(s) for s in (1, 3, 3)] == [None, 2, None]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _bowl_state(steps=3):
    loss, params, batch, _ = _bowl(True)
    step = make_train_step(loss, AdamWConfig())
    state = init_train_state(params)
    for _ in range(steps):
        state, _ = step(state, batch)
    return state


def test_checkpoint_roundtrip(tmp_path):
    state = _bowl_state()
    path = tckpt.save(str(tmp_path), 3, state, extra={"segment": 2})
    assert os.path.exists(os.path.join(path, "COMMIT"))
    assert os.path.exists(os.path.join(path, "manifest.json"))
    template = tree_map(torch.zeros_like, state)
    restored = tckpt.restore(str(tmp_path), 3, template)
    for (pa, a), (pb, b) in zip(leaves_with_paths(restored),
                                leaves_with_paths(state)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored.step) == 3
    assert tckpt.restore_extra(str(tmp_path), 3) == {"segment": 2}


def test_checkpoint_prune_and_latest(tmp_path):
    state = _bowl_state(0)
    for s in (1, 2, 3, 4, 5):
        tckpt.save(str(tmp_path), s, state, keep=3)
    assert tckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert tckpt.latest_step(str(tmp_path)) == 5


def test_uncommitted_checkpoint_ignored(tmp_path):
    state = _bowl_state(0)
    tckpt.save(str(tmp_path), 1, state)
    os.makedirs(os.path.join(tmp_path, "step_2"))        # a torn write
    assert tckpt.latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError, match="not committed"):
        tckpt.restore(str(tmp_path), 2, state)


def _model_states():
    """The reference's and the port's state after one step from the same
    carried weights."""
    jm, params, tm, tree = _carried("float32")
    jb, tb = _batch(tm.cfg)
    ocfg = dict(lr=1e-3, warmup_steps=0)
    js, _ = jax.jit(j_make_step(jm.loss, JAdamW(**ocfg)))(
        j_init_state(params), jb)
    ts, _ = make_train_step(tm.loss_fn, AdamWConfig(**ocfg))(
        init_train_state(tree), tb)
    return js, ts


def test_checkpoints_cross_between_packages(tmp_path):
    js, ts = _model_states()
    want_keys = list(jckpt._flatten_with_paths(js))
    assert list(tckpt._flatten_with_paths(ts)) == want_keys
    assert "params/layers/attn/wq" in want_keys and "opt/step" in want_keys

    # the reference writes, the port restores
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jdir, 1, js, extra={"segment": 0})
    got = tckpt.restore(jdir, 1, tree_map(torch.zeros_like, ts))
    jflat = jckpt._flatten_with_paths(js)
    for key, leaf in tckpt._flatten_with_paths(got).items():
        want = np.asarray(jflat[key])
        assert leaf.numpy().dtype == want.dtype, key
        assert np.array_equal(leaf.numpy(), want), key

    # the port writes, the reference restores
    tckpt.save(tdir, 1, ts, extra={"segment": 0})
    template = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, js))
    back = jckpt._flatten_with_paths(jckpt.restore(tdir, 1, template))
    tflat = tckpt._flatten_with_paths(ts)
    assert list(back) == want_keys
    for key, leaf in back.items():
        want = tflat[key].numpy()
        assert np.asarray(leaf).dtype == want.dtype, key
        assert np.array_equal(np.asarray(leaf), want), key
    assert tckpt.restore_extra(tdir, 1) == {"segment": 0}
