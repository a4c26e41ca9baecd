"""Port parity: the MoE family (``repro_torch.models.moe``, ``DecoderLM``
with ``num_experts > 0``; mixtral-8x7b with its 4,096-position sliding
window, phi3.5-moe) against the JAX package, on the CPU, at
``reduced=True`` (2 layers, d_model 128, 4 experts, top 2).

* The dispatch's integer state equals the reference's exactly at float32:
  each slot's expert ids and positions within the expert (captured from
  the reference's scatter calls) and the kept mask, in a case with dropped
  tokens (the default capacity factor 1.25, a router that favours one
  expert) and in a case with exact ties in the router probabilities (two
  equal router columns: the lower expert index comes first).
* Carried weights: ``forward`` logits and aux loss, ``loss``, four decode
  steps' logits and KV caches; float32 within 1e-5 of max |ref| (losses a
  relative 1e-5), bf16 within BF16_TOL (4 bf16 ulps of the largest logit:
  the bf16 router and expert products round in other orders; no expert
  choice flips on these inputs) and losses a relative 1e-2.
* The reference's oracles on the port: decode == forward (capacity factor
  8, float32, rtol = atol = 2e-3), the sliding-window ring buffer.
* ``loss_fn`` gradients equal ``jax.grad`` of the reference's loss (every
  leaf within 1e-4 of its max |grad|, none zero), and one ``Trainer`` step
  equals the reference's.
* Init: the router at 1/sqrt(d), the experts at 1/sqrt(E) (the
  reference's fan-in is a leaf's first dim).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import family_parity as fp
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
BF16_TOL = 4 * fp.BF16_ULP
NEAR_TIE = 2.0 ** -6


def _moe_case(arch, seed, tie=False, skew=0.0, b=2, s=32):
    """The reduced config's MoE params (reference init) and an input."""
    jc, _ = fp.configs(arch)
    mcfg = jmoe.MoEConfig(d_model=jc.d_model, d_ff=jc.d_ff,
                          num_experts=jc.num_experts, top_k=jc.top_k,
                          capacity_factor=jc.capacity_factor)
    from repro.models.layers import ParamCollector
    col = ParamCollector(jax.random.PRNGKey(seed))
    jmoe.moe_init(col, mcfg)
    p = fp.np_tree(col.done()[0])
    if tie:
        p["router"][:, 1] = p["router"][:, 0]
    x = np.random.default_rng(seed).normal(size=(b, s, jc.d_model))
    x = x + skew * p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    return mcfg, p, x.astype(np.float32)


def _reference_dispatch(monkeypatch, mcfg, p, x):
    """The reference's per-slot (expert ids, positions), read from the
    arguments of its vmapped scatter, and its output."""
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

    monkeypatch.setattr(jmoe, "jax", Spy())
    out, aux = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), mcfg,
                              jnp.asarray(x), return_aux=True)
    monkeypatch.undo()
    return calls, out, aux


def _port_moe(mcfg, p, x, **kw):
    tcfg = tmoe.MoEConfig(**{f: getattr(mcfg, f) for f in (
        "d_model", "d_ff", "num_experts", "top_k", "capacity_factor")})
    return tcfg, {k: torch.as_tensor(v) for k, v in p.items()}, \
        torch.as_tensor(x)


@pytest.mark.parametrize("case", ["drops", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_integer_state_equals_reference(monkeypatch, arch, case):
    mcfg, p, x = _moe_case(arch, seed=4, tie=case == "ties",
                           skew=6.0 if case == "drops" else 0.0)
    calls, jout, jaux = _reference_dispatch(monkeypatch, mcfg, p, x)
    tcfg, tp, tx = _port_moe(mcfg, p, x)
    tg = tx.reshape(1, -1, tcfg.d_model)
    probs = torch.softmax(torch.matmul(tg, tp["router"]), dim=-1)
    cap = tmoe.capacity(tcfg, tg.shape[1])
    _, ids, pos, keep = tmoe.moe_dispatch(probs, tcfg.top_k, cap)
    assert len(calls) == tcfg.top_k
    for slot, (jids, jpos) in enumerate(calls):
        assert np.array_equal(ids[..., slot].numpy(), jids)
        assert np.array_equal(pos[..., slot].numpy(), jpos)
        assert np.array_equal(keep[..., slot].numpy(), jpos < cap)
    if case == "drops":
        assert (~keep).sum() > 0           # tokens were dropped
    else:                                  # exact ties, lower index first
        top2 = torch.sort(probs, -1, descending=True).values[..., :2]
        tied = top2[..., 0] == top2[..., 1]
        assert tied.sum() > 0
        assert (ids[..., 0][tied] < ids[..., 1][tied]).all()
    tout, taux = tmoe.moe_apply(tp, tcfg, tx, return_aux=True)
    fp.close(tout, jout, fp.F32)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def _follow_reference_routing(monkeypatch):
    """Spies on both packages' dispatch: the reference's per-call routing
    (its scatter calls' expert ids and positions, in order) is queued, and
    the port's dispatch of the same call records where its own expert
    choice differs (with the smallest gap among its top k+1 probabilities
    at that token) and then routes as the reference did, so that a
    difference stays at the token where it arose."""
    queue, diffs = [], []

    class Spy:
        def __getattr__(self, name):
            return getattr(jax, name)

        def vmap(self, fn, *a, **k):
            real = jax.vmap(fn, *a, **k)

            def run(*args):
                if fn.__name__ == "_scatter_group":
                    queue.append((np.asarray(args[1]), np.asarray(args[2])))
                return real(*args)
            return run

    own = tmoe.moe_dispatch

    def dispatch(probs, k, cap):
        _, ids, _, _ = own(probs, k, cap)
        got = [queue.pop(0) for _ in range(k)]
        rids = torch.as_tensor(np.stack([g[0] for g in got], -1)).long()
        rpos = torch.as_tensor(np.stack([g[1] for g in got], -1)).long()
        differ = (ids != rids).any(-1)
        if differ.any():
            top = torch.sort(probs, -1, descending=True).values[..., :k + 1]
            gap = (top[..., :-1] - top[..., 1:]).min(-1).values
            diffs.extend(gap[differ].tolist())
        gate = torch.take_along_dim(probs, rids, -1)
        gate = gate / torch.clamp(torch.sum(gate, -1, keepdim=True), min=1e-9)
        return gate, rids, rpos, rpos < cap

    monkeypatch.setattr(jmoe, "jax", Spy())
    monkeypatch.setattr(tmoe, "moe_dispatch", dispatch)
    return queue, diffs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_carried_weights_give_reference_outputs(monkeypatch, arch, dtype):
    """The reference runs without jit (its layer scan as a Python loop, so
    its routing is concrete); the port follows the reference's routing and
    every expert choice of its own must be the reference's: all of them at
    float32, and at bf16 all but near ties (top-(k+1) probabilities within
    NEAR_TIE: a bf16 router logit is rounded to 2^-8 of itself)."""
    jm, params, tm = fp.pair(arch, dtype)
    queue, diffs = _follow_reference_routing(monkeypatch)
    f32 = dtype == "float32"
    tol = fp.F32 if f32 else BF16_TOL
    jb, tb = fp.batch(tm.cfg)
    with jax.disable_jit():
        jl, jaux = fp.j_forward(jm, params, jb)
        tl, taux = fp.t_forward(tm, tb)
        assert tl.dtype == getattr(torch, dtype) and \
            taux.dtype == torch.float32
        fp.close(tl, jl, tol, "logits")
        assert float(taux) == pytest.approx(float(jaux),
                                            rel=1e-5 if f32 else 1e-2)
        jloss = float(jm.loss(params, jb))
        assert float(tm.loss(tb)) == pytest.approx(jloss,
                                                   rel=1e-5 if f32 else 1e-2)
        steps, jc, tc = fp.decode_steps(jm, params, tm,
                                        np.asarray(jb["tokens"]), dtype)
    for jd, td in steps:
        fp.close(td, jd, tol, "decode logits")
    fp.same_caches(jc, tc, tol)
    assert not queue
    assert all(g < (0.0 if f32 else NEAR_TIE) for g in diffs), diffs


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's oracle on the port (capacity factor 8: one-token
    and full-sequence dispatch then drop nothing)."""
    _, tc = fp.configs(arch, capacity_factor=8.0)
    tm = fp.t_build(tc, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 12)))
    fp.decode_matches_forward(tm, toks)


def test_swa_ring_buffer_masks_old_tokens():
    """Window 4: decode through a four-slot ring buffer == the banded
    full-sequence mask (the reference's oracle, on the port)."""
    _, tc = fp.configs("mixtral-8x7b", window=4, capacity_factor=8.0)
    tm = fp.t_build(tc, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab_size, (1, 10)))
    assert tm.init_cache(1, 64)["k"].shape[2] == 4
    fp.decode_matches_forward(tm, toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    fp.grads_match(arch)


def test_trainer_step_matches_reference():
    fp.trainer_step_matches("mixtral-8x7b")


def test_init_draws_the_reference_distribution():
    _, tc = fp.configs("phi3.5-moe-42b-a6.6b")
    tm = fp.t_build(tc, device="cpu", seed=2)
    moe = tm.layers[0].moe
    d, e = tc.d_model, tc.num_experts
    for w, scale in ((moe.router, 1 / np.sqrt(d)), (moe.gate, 1 / np.sqrt(e)),
                     (moe.down, 1 / np.sqrt(e))):
        w = w.numpy()
        assert np.abs(w).max() <= 2.0 * scale
        assert 0.85 < w.std() / scale < 0.9


def test_engine_tokens_equal_reference():
    fp.engine_tokens_match("mixtral-8x7b")
