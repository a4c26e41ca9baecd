"""Port parity: the xLSTM family (``repro_torch.models.xlstm``,
``xlstm_model.py``; xlstm-125m at ``reduced=True``: an mLSTM and an sLSTM
block, d_model 128, chunk 32) against the JAX package, on the CPU.

* ``mlstm_inner_chunked`` runs when S > 2·chunk (here S = 80, two and a
  half chunks): the port's chunkwise mLSTM block equals the reference's
  chunkwise block and the port's own quadratic form (the same block with
  a chunk above S/2) within 1e-5 of max |ref| at float32.  The inner
  function on its own equals the reference's within 1e-5 of max |ref|,
  and its float32 error against its float64 run (the port's function on
  float64 inputs: the reference's computes in float32 whatever its
  inputs) is at most twice the reference's against that same run.
* ``slstm_forward`` at bf16 with its bf16 state against the reference's
  within 2 bf16 ulps.
* Carried weights: ``forward`` logits and ``loss`` (S = 16 and S = 80,
  the chunkwise path), four decode steps' logits and every block's
  float32 cache (C, n, m, conv; c, n, h, m, conv), float32 within 1e-5 of
  max |ref|, bf16 within 2 bf16 ulps
  (the decode after the sLSTM block runs in float32, as the reference's
  mixed operands promote), losses a relative 1e-5 / 1e-2.
* The reference's decode == forward oracle on the port (float32, rtol =
  atol = 2e-3); ``loss_fn`` gradients equal ``jax.grad`` of the
  reference's loss (every leaf within 1e-4 of its max |grad|, none zero);
  one ``Trainer`` step equals the reference's.
* Init: the mLSTM's ``w_i``/``w_f`` at 0.01, the sLSTM's ``w_*`` at
  1/sqrt(d) and ``r_*`` at 0.1; the sLSTM cache's ``n`` starts at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import family_parity as fp
from repro.models import xlstm as jx
from repro_torch.models import xlstm as tx

BF16_TOL = 2 * fp.BF16_ULP


def _block(arch_model, kind):
    return next(b for b, k in zip(arch_model.blocks, arch_model.kinds)
                if k == kind)


def _u(tm, s, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).normal(
        size=(2, s, tm.cfg.d_model)).astype(dtype)


def test_chunkwise_mlstm_equals_reference_and_quadratic_form():
    jm, params, tm = fp.pair("xlstm-125m")
    xc = tm.xcfg
    assert xc.chunk == 32
    p_t = tm.compute_params()["blocks"][0]
    p_j = params["blocks"][0]
    u = _u(tm, 80)
    got = tx.mlstm_forward(p_t, xc, torch.as_tensor(u))
    want = jx.mlstm_forward(p_j, jx.XLSTMConfig(d_model=xc.d_model,
                                                num_heads=xc.num_heads,
                                                chunk=32), jnp.asarray(u))
    quad = tx.mlstm_forward(p_t, dataclasses.replace(xc, chunk=64),
                            torch.as_tensor(u))
    fp.close(got, want, fp.F32, "chunkwise vs reference")
    fp.close(got, quad, fp.F32, "chunkwise vs quadratic")
    # the inner function on its own, the reference's against the port's
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 80, 4, 16)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.normal(size=(2, 80, 4)).astype(np.float32)
    f_pre = (rng.normal(size=(2, 80, 4)) + 3).astype(np.float32)
    args = (q, k, v, i_pre, f_pre)
    got = tx.mlstm_inner_chunked(*map(torch.as_tensor, args), chunk=32)
    want = jx.mlstm_inner_chunked(*map(jnp.asarray, args), chunk=32)
    exact = tx.mlstm_inner_chunked(
        *[torch.as_tensor(a, dtype=torch.float64) for a in args], chunk=32)
    fp.close(got, want, fp.F32, "inner")
    port_err = float((got.double() - exact).abs().max())
    ref_err = float(np.abs(fp.f64(want) - exact.numpy()).max())
    assert 0 < port_err <= 2 * ref_err


def test_slstm_forward_bf16_state_matches_reference():
    jm, params, tm = fp.pair("xlstm-125m", "bfloat16")
    i = tm.kinds.index("slstm")
    u = _u(tm, 24, seed=1)
    got = tx.slstm_forward(tm.compute_params()["blocks"][i], tm.xcfg,
                           torch.as_tensor(u).to(torch.bfloat16))
    want = jx.slstm_forward(params["blocks"][i], jx.XLSTMConfig(
        d_model=tm.cfg.d_model, num_heads=tm.cfg.num_heads, chunk=32),
        jnp.asarray(u).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    fp.close(got, want, BF16_TOL)


@pytest.mark.parametrize("s", [16, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carried_weights_give_reference_outputs(dtype, s):
    jm, params, tm = fp.pair("xlstm-125m", dtype)
    f32 = dtype == "float32"
    tol = fp.F32 if f32 else BF16_TOL
    jb, tb = fp.batch(tm.cfg, s=s)
    jl, _ = fp.j_forward(jm, params, jb)
    tl, _ = fp.t_forward(tm, tb)
    assert tl.dtype == getattr(torch, dtype)
    fp.close(tl, jl, tol, "logits")
    assert float(tm.loss(tb)) == pytest.approx(float(jm.loss(params, jb)),
                                               rel=1e-5 if f32 else 1e-2)
    if s > 16:
        return
    steps, jc, tc = fp.decode_steps(jm, params, tm, np.asarray(jb["tokens"]),
                                    dtype, cache_dtype="float32")
    for jd, td in steps:
        fp.close(td, jd, tol, "decode logits")
    fp.same_caches(jc, tc, tol)
    assert all(c["conv"].dtype == torch.float32 for c in tc)


def test_decode_matches_forward():
    _, tc = fp.configs("xlstm-125m")
    tm = fp.t_build(tc, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 12)))
    fp.decode_matches_forward(tm, toks)


def test_gradients_match_reference():
    fp.grads_match("xlstm-125m")


def test_trainer_step_matches_reference():
    fp.trainer_step_matches("xlstm-125m")


def test_init_draws_the_reference_distribution():
    _, tc = fp.configs("xlstm-125m")
    tm = fp.t_build(tc, device="cpu", seed=2)
    m, s = _block(tm, "mlstm"), _block(tm, "slstm")
    d = tc.d_model
    for w, scale in ((m.w_i, 0.01), (m.w_f, 0.01), (s.w_i, 1 / np.sqrt(d)),
                     (s.r_f, 0.1), (m.wq, 1 / np.sqrt(2 * d))):
        w = w.numpy()
        assert np.abs(w).max() <= 2 * scale and 0.8 < w.std() / scale < 0.92
    assert not m.b_f.numpy().any() and not s.b_z.numpy().any()
    assert (s.gnorm.numpy() == 1).all() and (m.mnorm.numpy() == 1).all()
    cache = tm.init_cache(2, 64)
    assert cache[0]["C"].dtype == torch.float32
    i = tm.kinds.index("slstm")
    assert torch.equal(cache[i]["n"], torch.full_like(cache[i]["n"], 1e-6))


def test_engine_tokens_equal_reference():
    fp.engine_tokens_match("xlstm-125m")
