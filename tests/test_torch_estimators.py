"""Port parity: the bi-level estimators (Eq. 1-3), confidence bounds, error
ratio and HAVING verdicts against the JAX package.

The same float32 statistics go through both.  Reductions over chunks run in
another order in the two frameworks, so float results agree to a relative
1e-5 (float32 sums of a few hundred terms; the variance's cancellation
``cross - sum²/m`` keeps the same order of error since every input is the
same float32 value); validity flags and verdicts must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as je
from repro_torch.core import estimators as te

RTOL = 1e-5


def _stats(seed, q=3, n=40, per_slot_m=False, census=False):
    rng = np.random.default_rng(seed)
    big_m = rng.integers(50, 200, n).astype(np.int32)
    m = np.minimum(rng.integers(0, 120, (q, n) if per_slot_m else n),
                   big_m).astype(np.int32)
    if census:
        m = np.broadcast_to(big_m, m.shape).copy()
    m[..., :3] = 0                            # chunks outside the sample
    m[..., 3] = 1                             # a singleton chunk
    x = rng.gamma(2.0, 50.0, (q, n)).astype(np.float32)
    ysum = (x * m).astype(np.float32)
    ysq = (x * x * m * 1.3).astype(np.float32)
    psum = np.floor(m * rng.random((q, n))).astype(np.float32)
    return big_m, m, ysum, ysq, psum


def _pair(seed, **kw):
    big_m, m, ysum, ysq, psum = _stats(seed, **kw)
    n = big_m.shape[0]
    j = je.BiLevelStats(M=jnp.asarray(big_m), m=jnp.asarray(m),
                        ysum=jnp.asarray(ysum), ysq=jnp.asarray(ysq),
                        psum=jnp.asarray(psum), n_total=n,
                        m_total=int(big_m.sum()))
    t = te.BiLevelStats(M=torch.as_tensor(big_m), m=torch.as_tensor(m),
                        ysum=torch.as_tensor(ysum), ysq=torch.as_tensor(ysq),
                        psum=torch.as_tensor(psum), n_total=n,
                        m_total=int(big_m.sum()))
    return j, t


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(per_slot_m=True),
                                dict(census=True)])
def test_estimators_match(kw):
    j, t = _pair(11, **kw)
    _close(te.tau_hat(t), je.tau_hat(j))
    _close(te.count_tau_hat(t), je.count_tau_hat(j))
    for tf, jf in ((te.var_hat, je.var_hat),
                   (te.count_var_hat, je.count_var_hat)):
        (tv, tok), (jv, jok) = tf(t), jf(j)
        _close(tv, jv)
        assert np.array_equal(tok.numpy(), np.asarray(jok))
    tr, tvr, tok = te.avg_estimate(t)
    jr, jvr, jok = je.avg_estimate(j)
    _close(tr, jr)
    _close(tvr, jvr)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert np.array_equal(t.n.numpy(), np.asarray(j.n))


def test_single_chunk_sample_is_infinite_variance():
    j, t = _pair(3, q=1, n=6)
    m = np.zeros(6, np.int32)
    m[4] = 10
    tv, tok = te.var_hat(t._replace(m=torch.as_tensor(m)))
    jv, jok = je.var_hat(j._replace(m=jnp.asarray(m)))
    assert np.isinf(tv.numpy()).all() and np.isinf(np.asarray(jv)).all()
    assert not tok.numpy().any() and not np.asarray(jok).any()


@pytest.mark.parametrize("conf", [0.8, 0.9, 0.95, 0.99])
def test_confidence_bounds_and_error_ratio(conf):
    est = np.asarray([1.0e6, -3.0e4, 5.0, 0.0], np.float32)
    var = np.asarray([4.0e8, 1.0e6, 0.25, 1.0], np.float32)
    tlo, thi = te.confidence_bounds(torch.as_tensor(est),
                                    torch.as_tensor(var), conf)
    jlo, jhi = je.confidence_bounds(jnp.asarray(est), jnp.asarray(var), conf)
    # z = ndtri((1+c)/2) in float32: torch.special.ndtri and jax's ndtri
    # may differ in the last ulp, hence the relative tolerance here
    _close(tlo, jlo)
    _close(thi, jhi)
    _close(te.error_ratio(torch.as_tensor(est), tlo, thi),
           je.error_ratio(jnp.asarray(est), jlo, jhi))


def test_having_decision_coded_matches_at_thresholds():
    rng = np.random.default_rng(2)
    lo = rng.normal(0, 1, 64).astype(np.float32)
    hi = lo + np.abs(rng.normal(0, 1, 64)).astype(np.float32)
    lo[:8] = 0.5                  # bounds sitting exactly on the threshold
    hi[8:16] = 0.5
    op = rng.integers(-1, 4, 64).astype(np.int32)
    got = te.having_decision_coded(torch.as_tensor(lo), torch.as_tensor(hi),
                                   torch.as_tensor(op), 0.5)
    want = je.having_decision_coded(jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(op), 0.5)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), np.asarray(want))
    for name in ("<", "<=", ">", ">="):
        assert int(te.having_decision(0.2, 0.5, name, 0.5)) == int(
            je.having_decision(0.2, 0.5, name, 0.5))
    with pytest.raises(ValueError):
        te.having_decision(0.0, 1.0, "==", 0.5)


def test_init_stats_shapes():
    sizes = torch.tensor([10, 20, 30], dtype=torch.int32)
    st = te.init_stats(sizes, query_shape=(4,))
    assert st.ysum.shape == (4, 3) and st.m.shape == (3,)
    assert st.n_total == 3 and st.m_total == 60


@pytest.mark.parametrize("kw", [dict(), dict(per_slot_m=True)])
def test_merge_matches(kw):
    """Two disjoint samples of one table merged: integer fields equal,
    float fields within float32's tolerance."""
    ja, ta = _pair(21, **kw)
    jb, tb = _pair(22, **kw)
    jb = jb._replace(M=ja.M)
    tb = tb._replace(M=ta.M)
    j, t = ja.merge(jb), ta.merge(tb)
    assert (t.n_total, t.m_total) == (j.n_total, j.m_total)
    for name in ("M", "m"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    for name in ("ysum", "ysq", "psum"):
        _close(getattr(t, name), getattr(j, name))
    _close(te.tau_hat(t), je.tau_hat(j))
