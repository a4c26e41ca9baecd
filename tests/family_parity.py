"""Shared helpers of the model families' parity tests
(``tests/test_torch_moe.py``, ``test_torch_vlm_encdec.py``,
``test_torch_ssm_zamba.py``, ``test_torch_xlstm.py``): reduced configs of
both packages, the reference's weights carried into the port, batches of
each family from a numpy seed, and the comparisons.

Tolerances are stated as fractions of the reference's largest magnitude:
``F32`` (1e-5, the two libraries' float32 products sum in other orders)
and ``BF16_ULP`` (2^-7, one bf16 ulp at the largest entry)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_config
from repro.models import build_model as j_build
from repro.models.vlm import build_positions3
from repro_torch.configs import get_config as t_config
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import load_reference_params
from repro_torch.models.convert import tree_from_reference
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import leaves, leaves_with_paths

F32 = 1e-5
BF16_ULP = 2.0 ** -7
B, S = 2, 16


def configs(arch: str, dtype: str = "float32", **overrides):
    jc = dataclasses.replace(j_config(arch, reduced=True),
                             compute_dtype=dtype, **overrides)
    tc = dataclasses.replace(t_config(arch, reduced=True),
                             compute_dtype=dtype, **overrides)
    return jc, tc


def pair(arch: str, dtype: str = "float32", key: int = 1, **overrides):
    """(reference model, its params, the port's model carrying them)."""
    jc, tc = configs(arch, dtype, **overrides)
    jm = j_build(jc)
    params, _ = jm.init(jax.random.PRNGKey(key))
    tm = t_build(tc, device="cpu", seed=5)
    load_reference_params(tm, np_tree(params))
    return jm, params, tm


def np_tree(params):
    return jax.tree.map(np.array, params)


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(np.asarray(a, np.float32), np.float64)


def close(got, want, tol_frac: float, what: str = "") -> float:
    """max |got - want| <= tol_frac · max |want|; returns the ratio."""
    got, want = f64(got), f64(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol_frac * scale, (what, err, tol_frac * scale)
    return err / max(scale, 1e-30)


def batch(cfg, seed: int = 0, b: int = B, s: int = S, s_vis: int = 4,
          s_enc: int = 10):
    """(reference batch of jnp arrays, port batch of tensors) of the
    family's shape: tokens and labels; the VLM's ``vis_embeds`` (the first
    ``s_vis`` of ``s`` positions) and ``positions3``; the encoder-decoder's
    ``enc_embeds`` (B, s_enc, d)."""
    rng = np.random.default_rng(seed)
    out = {}
    s_txt = s - s_vis if cfg.family == "vlm" else s
    out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s_txt)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s_txt)).astype(np.int32)
    if cfg.family == "vlm":
        out["vis_embeds"] = rng.normal(size=(b, s_vis, cfg.d_model)).astype(
            np.float32)
        out["positions3"] = build_positions3(b, s_vis, s_txt)
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.normal(size=(b, s_enc, cfg.d_model)).astype(
            np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.as_tensor(np.array(v)) for k, v in out.items()})


def j_forward(jm, params, jb):
    """The reference's logits and aux loss (0 for families without one)."""
    fam = jm.cfg.family
    out = jm.forward(params, jb) if fam in ("vlm", "encdec") else jm.forward(
        params, jb["tokens"])
    return out if isinstance(out, tuple) else (out, 0.0)


def t_forward(tm, tb):
    fam = tm.cfg.family
    out = tm.forward(tb) if fam in ("vlm", "encdec") else tm.forward(
        tb["tokens"])
    return out if isinstance(out, tuple) else (out, 0.0)


NOISE = 1e-6


def _leaf_errors(got, want, tol: float, floor: float) -> float:
    """Each leaf of ``got`` (tensors) within ``tol`` of its max |want|
    (numpy): the worst ratio.  A leaf whose reference is below ``floor``
    everywhere (zero, or rounding noise around a true zero: e.g. the input
    gate's bias, whose shift the stabiliser ``m`` cancels) must be below
    ``floor`` in the port too, and non-zero leaves non-zero."""
    worst = 0.0
    for path, g in got.items():
        w = np.asarray(want[path], np.float64)
        g = g.double().numpy()
        assert g.shape == w.shape, path
        scale = np.abs(w).max()
        if scale <= floor:
            assert np.abs(g).max() <= floor, path
            continue
        assert np.abs(g).max() > 0, path
        err = np.abs(g - w).max() / scale
        assert err <= tol, (path, err)
        worst = max(worst, err)
    return worst


def grads_match(arch: str, tol: float = 1e-4, **overrides):
    """``loss_fn`` gradients against ``jax.grad`` of the reference's loss at
    float32 compute: every leaf within ``tol`` of its max |grad| and
    non-zero unless the reference's is zero too (below NOISE of the
    tree's largest gradient: ``_leaf_errors``).  Returns the worst
    ratio."""
    jm, params, tm = pair(arch, "float32", **overrides)
    jb, tb = batch(tm.cfg, seed=3)
    jl, jg = jax.value_and_grad(jm.loss)(params, jb)
    tree = tree_from_reference(np_tree(params), "cpu", model=tm)
    tl, tg = value_and_grad(tm.loss_fn, tree, tb)
    assert abs(float(tl) - float(jl)) <= F32 * abs(float(jl))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    got = dict(leaves_with_paths(tg))
    assert list(got) == list(want)
    assert all(leaf.dtype == torch.float32 for leaf in leaves(tg))
    top = max(np.abs(w).max() for w in want.values())
    return _leaf_errors(got, want, tol, NOISE * top)


def trainer_step_matches(arch: str) -> dict:
    """One ``Trainer`` step of both packages from the same weights (the
    reference's ``init_state``) on the same one-segment corpus at float32
    compute: the same gate decision, the loss within a relative 1e-5, the
    ``grad_norm`` and the first and second moments (the step's gradients)
    within 1e-4 of their largest magnitude (``_leaf_errors``), the parameters within 1e-5 of
    their largest where the gradient is not near zero and within 2·lr
    elsewhere."""
    from repro.data.corpus import SyntheticCorpus as JCorpus
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.data.corpus import SyntheticCorpus as TCorpus
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    jc, tc = configs(arch)
    kw = dict(steps_per_segment=1, batch=2, seq_len=32, max_steps=1)
    corpus = dict(num_segments=1, docs_per_segment=64, doc_len=32,
                  poison_every=0, seed=0)
    jt = JTrainer(jc, JTrainerConfig(**kw))
    jstate = jt.init_state()
    tt = Trainer(tc, TrainerConfig(**kw), device="cpu")
    tstate = init_train_state(tree_from_reference(
        np_tree(jstate.params), "cpu", model=tt.model))
    jres = jt.run(JCorpus(vocab=jc.vocab_size, **corpus), state=jstate)
    tres = tt.run(TCorpus(vocab=tc.vocab_size, **corpus), state=tstate)
    assert (tres["steps"], tres["admitted"]) == (jres["steps"],
                                                 jres["admitted"]) == (1, 1)
    jstep = [e for e in jt.log if e["event"] == "step"][0]
    tstep = [e for e in tt.log if e["event"] == "step"][0]
    assert abs(tstep["loss"] - jstep["loss"]) <= F32 * abs(jstep["loss"])
    assert abs(tstep["grad_norm"] - jstep["grad_norm"]) <= \
        1e-4 * jstep["grad_norm"]
    js, ts = jres["state"], tres["state"]
    for got, want, noise in ((ts.opt.mu, js.opt.mu, NOISE),
                             (ts.opt.nu, js.opt.nu, NOISE ** 2)):
        want = dict(leaves_with_paths(jax.tree.map(np.asarray, want)))
        top = max(np.abs(w).max() for w in want.values())
        _leaf_errors(dict(leaves_with_paths(got)), want, 1e-4, noise * top)
    # the first Adam step is sign-SGD at rate lr: a near-zero gradient may
    # move its parameter by +-lr in either package
    lr = 2 * float(jstep_lr(jt))
    mus = [np.abs(np.asarray(m)) for m in jax.tree.leaves(js.opt.mu)]
    floor = NOISE * max(m.max() for m in mus)
    for g, w, m in zip(leaves(ts.params), jax.tree.leaves(js.params), mus):
        w = np.asarray(w, np.float64)
        d = np.abs(g.double().numpy() - w)
        steady = m > max(1e-3 * m.max(), floor)
        assert d[steady].max(initial=0) <= F32 * np.abs(w).max()
        assert d[~steady].max(initial=0) <= lr
    return {"loss": tstep["loss"], "ref_loss": jstep["loss"]}


def jstep_lr(jtrainer) -> float:
    """The rate of the reference trainer's first step."""
    from repro.train.optimizer import lr_at
    return float(lr_at(jtrainer.opt_cfg, jnp.asarray(1)))


def decode_matches_forward(tm, tokens: torch.Tensor, max_len: int = 64):
    """The reference oracle's teacher-forced decode (float32 cache) against
    the port's own full-sequence forward, rtol = atol = 2e-3."""
    full, _ = t_forward(tm, {"tokens": tokens})
    cache = tm.init_cache(tokens.shape[0], max_len, dtype=torch.float32)
    outs = []
    for t in range(tokens.shape[1]):
        pos = torch.full((tokens.shape[0],), t, dtype=torch.int32)
        logits, cache = tm.decode_step(cache, tokens[:, t:t + 1], pos)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def decode_steps(jm, params, tm, toks: np.ndarray, dtype: str,
                 steps: int = 4, max_len: int = 32, cache_dtype=None):
    """``steps`` decode steps of both packages, the two slots at different
    positions: [(reference logits, port logits), ...] and the final
    caches.  ``cache_dtype`` None takes each ``init_cache``'s default at
    bf16 and float32 at float32 compute."""
    f32 = dtype == "float32" if cache_dtype is None else cache_dtype == \
        "float32"
    jkw = {"dtype": jnp.float32} if f32 else {}
    tkw = {"dtype": torch.float32} if f32 else {}
    if cache_dtype == "bfloat16":
        jkw, tkw = {"dtype": jnp.bfloat16}, {"dtype": torch.bfloat16}
    toks = np.array(toks)
    jcache = jm.init_cache(toks.shape[0], max_len, **jkw)
    tcache = tm.init_cache(toks.shape[0], max_len, **tkw)
    out = []
    for t in range(steps):
        pos = np.full(toks.shape[0], t, np.int32)
        pos[1] = t + 3
        jd, jcache = jm.decode_step(params, jcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(pos))
        td, tcache = tm.decode_step(tcache, torch.as_tensor(toks[:, t:t + 1]),
                                    torch.as_tensor(pos))
        out.append((jd, td))
    return out, jcache, tcache


def same_caches(jcache, tcache, tol: float) -> None:
    """Every cache leaf of the port against the reference's, in its dtype:
    integer leaves equal, float leaves within ``tol`` of max |ref|."""
    jl = dict(leaves_with_paths(jax.tree.map(np.asarray, jcache)))
    tl = dict(leaves_with_paths(tcache))
    assert list(jl) == list(tl)
    for path, want in jl.items():
        got = tl[path]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        if np.issubdtype(want.dtype, np.integer):
            assert np.array_equal(got.numpy(), want), path
        else:
            close(got, want, tol, str(path))


def engine_tokens_match(arch: str, requests: int = 6, max_new: int = 12):
    """``ServeEngine`` of both packages at float32 compute, the reference
    engine's weights carried into the port's, serve_batched.py's shape (3
    slots, 8-token prompts): every decode call's logits within one bf16 ulp
    of the reference's max |logit| (the engines hold bf16 KV caches, as the
    reference's: a float32 difference can round a cached entry to the
    neighbouring bf16 value), the same decode-step count and the same
    tokens request for request (greedy argmax).  Where the port's own
    argmax differs from the reference's, the logits of the two tokens lie
    within those calls' difference (a near tie: which one wins depends on
    the CPU's thread count), and the port takes the reference's token so
    that the rest is still compared.  Returns the count of such ties."""
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JEngine
    from repro_torch.serve.engine import Request as TRequest
    from repro_torch.serve.engine import ServeEngine as TEngine

    jc, tc = configs(arch)
    je = JEngine(jc, batch_slots=3, max_len=64, seed=0)
    te = TEngine(tc, batch_slots=3, max_len=64, seed=0, device="cpu")
    load_reference_params(te.model, np_tree(je.params))
    want, ties = [], []
    j_decode, t_decode = je.decode, te._decode

    def j_spy(*args):
        logits, cache = j_decode(*args)
        want.append(np.asarray(logits[:, 0], np.float64))
        return logits, cache

    def t_spy(toks, posv):
        logits = t_decode(toks, posv)
        got, ref = f64(logits[:, 0]), want[len(ties)]
        err = np.abs(got - ref).max()
        assert err <= BF16_ULP * np.abs(ref).max(), (len(ties), err)
        own, theirs = got.argmax(-1), ref.argmax(-1)
        flips = np.nonzero(own != theirs)[0]
        logits[flips, 0, theirs[flips]] = logits[flips, 0, own[flips]] + 1
        ties.append(len(flips))
        return logits

    je.decode, te._decode = j_spy, t_spy
    out = []
    for eng, req in ((je, JRequest), (te, TRequest)):
        rng = np.random.default_rng(0)
        reqs = [req(rid=i, prompt=rng.integers(0, jc.vocab_size, 8)
                    .astype(np.int32), max_new=max_new)
                for i in range(requests)]
        for r in reqs:
            eng.submit(r)
        out.append((eng.run(), [(r.done, r.out_tokens) for r in reqs]))
    assert len(ties) == len(want)
    assert out[1] == out[0]
    assert all(done and len(toks) == max_new for done, toks in out[1][1])
    return sum(ties)