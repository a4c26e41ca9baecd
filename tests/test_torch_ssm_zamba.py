"""Port parity: the Mamba2 SSM (``repro_torch.models.ssm``) and the
zamba2 hybrid (``models/zamba.py``) against the JAX package, on the CPU,
at ``reduced=True`` (2 Mamba layers, a shared attention block after each
second, chunk 32).

* The reference's oracle on the port: chunked SSD == the naive float64
  recurrence (rtol = atol = 2e-4), with and without padding to the chunk.
* ``ssd_chunked`` against the reference's at float32 over several chunks
  with padding, within 1e-5 of max |ref|; and its own float32 error
  (against its float64 run, itself held to the naive float64 recurrence
  within 1e-10) at most twice the reference's (the reference's float32
  result against its float64 run under ``jax.enable_x64``): ``_segsum``
  takes differences of cumulative sums, so a precision fault shows there.
* Carried weights (zamba2-1.2b reduced, and with ``long_window`` 5 so the
  shared block's decode runs a five-slot ring buffer): ``forward``
  logits and ``loss``, seven decode steps' logits, the float32 Mamba
  states and the shared KV caches; float32 within 1e-5 of max |ref|, bf16
  within BF16_TOL (8 bf16 ulps: the chunked scan runs in bf16 and its
  cumulative sums cancel) and losses a relative 1e-5 / 1e-2.
* The reference's decode == forward oracle on the port (float32, rtol =
  atol = 2e-3); ``loss_fn`` gradients equal ``jax.grad`` of the
  reference's loss (every leaf within 1e-4 of its max |grad|, none zero);
  one ``Trainer`` step equals the reference's.
* Init: ``A_log``, ``D`` and ``dt_bias`` zero, ``conv`` at 1/sqrt(4),
  ``site_proj`` at 1/sqrt(sites).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import family_parity as fp
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

BF16_TOL = 8 * fp.BF16_ULP


def _ssd_inputs(seed, b=2, s=16, h=3, p=4, n=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, p)).astype(dtype),
            rng.uniform(0.1, 0.9, (b, s, h)).astype(dtype),
            (-rng.uniform(0.5, 1.5, h)).astype(dtype),
            rng.normal(size=(b, s, n)).astype(dtype),
            rng.normal(size=(b, s, n)).astype(dtype))


def _stepwise(x, dt, a, bb, cc):
    """The reference oracle's naive float64 recurrence."""
    b, s, h, p = x.shape
    state = np.zeros((b, h, p, bb.shape[-1]))
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None])
        state = state * decay[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], bb[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", state, cc[:, t]))
    return np.stack(ys, 1), state


@pytest.mark.parametrize("s,chunk", [(16, 4), (19, 4), (16, 32)])
def test_ssd_chunked_matches_stepwise(s, chunk):
    args = _ssd_inputs(0, s=s)
    y, h_last = tssm.ssd_chunked(*map(torch.as_tensor, args), chunk=chunk)
    want_y, want_h = _stepwise(*[a.astype(np.float64) for a in args])
    np.testing.assert_allclose(y.numpy(), want_y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h_last.numpy(), want_h, rtol=2e-4, atol=2e-4)


def test_ssd_chunked_matches_reference_within_forward_error():
    args = _ssd_inputs(1, b=2, s=100, h=4, p=8, n=16)
    a64 = [a.astype(np.float64) for a in args]
    got = tssm.ssd_chunked(*map(torch.as_tensor, args), chunk=32)
    want = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=32)
    exact = tssm.ssd_chunked(*map(torch.as_tensor, a64), chunk=32)
    with jax.enable_x64(True):
        want64 = jssm.ssd_chunked(*map(jnp.asarray, a64), chunk=32)
        want64 = [np.asarray(w) for w in want64]
    naive, naive_h = _stepwise(*a64)
    assert np.abs(exact[0].numpy() - naive).max() <= 1e-10 * np.abs(naive).max()
    assert np.abs(exact[1].numpy() - naive_h).max() <= (
        1e-10 * np.abs(naive_h).max())
    for g, w, e, w64 in zip(got, want, exact, want64):
        fp.close(g, w, fp.F32)
        assert np.abs(w64 - e.numpy()).max() <= 1e-10 * np.abs(w64).max()
        port_err = float((g.double() - e).abs().max())
        ref_err = float(np.abs(fp.f64(w) - w64).max())
        assert 0 < port_err <= 2 * ref_err


CASES = [{}, {"long_window": 5}]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("overrides", CASES, ids=["window4096", "window5"])
def test_carried_weights_give_reference_outputs(overrides, dtype):
    jm, params, tm = fp.pair("zamba2-1.2b", dtype, **overrides)
    f32 = dtype == "float32"
    tol = fp.F32 if f32 else BF16_TOL
    jb, tb = fp.batch(tm.cfg, s=48)
    jl, _ = fp.j_forward(jm, params, jb)
    tl, _ = fp.t_forward(tm, tb)
    assert tl.dtype == getattr(torch, dtype)
    fp.close(tl, jl, tol, "logits")
    assert float(tm.loss(tb)) == pytest.approx(float(jm.loss(params, jb)),
                                               rel=1e-5 if f32 else 1e-2)
    assert torch.equal(tm.prefill(tb["tokens"]), tl[:, -1:])
    steps, jc, tc = fp.decode_steps(jm, params, tm, np.asarray(jb["tokens"]),
                                    dtype, steps=7)
    for jd, td in steps:
        fp.close(td, jd, tol, "decode logits")
    fp.same_caches(jc, tc, tol)
    assert tc["mamba"]["ssm"].dtype == torch.float32
    assert tc["shared"]["k"].shape[:3] == (
        len(tm.sites), fp.B, min(32, overrides.get("long_window", 4096)))


def test_decode_matches_forward():
    _, tc = fp.configs("zamba2-1.2b")
    tm = fp.t_build(tc, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 12)))
    fp.decode_matches_forward(tm, toks)


def test_gradients_match_reference():
    fp.grads_match("zamba2-1.2b")


def test_trainer_step_matches_reference():
    fp.trainer_step_matches("zamba2-1.2b")


def test_init_draws_the_reference_distribution():
    _, tc = fp.configs("zamba2-1.2b")
    tm = fp.t_build(tc, device="cpu", seed=2)
    m = tm.layers[1].m
    for zero in (m.A_log, m.D, m.dt_bias):
        assert not zero.numpy().any()
    assert (m.norm.numpy() == 1).all() and (tm.layers[0].ln.numpy() == 1).all()
    for w, scale in ((m.conv, 0.5), (tm.site_proj, 1 / np.sqrt(len(tm.sites))),
                     (m.in_dt, 1 / np.sqrt(tc.d_model))):
        w = w.numpy()
        assert np.abs(w).max() <= 2 * scale and 0.8 < w.std() / scale < 0.92


def test_engine_tokens_equal_reference():
    fp.engine_tokens_match("zamba2-1.2b")
