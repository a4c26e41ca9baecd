"""Port parity: the frozen plane's verification chain and its helpers
against the JAX package, on the CPU.

* ``EstimationController.run_verification`` on the chain of
  ``tests/test_controller_serve.py`` (4,096 tuples, 32 ASCII chunks) and
  on ``examples/explore_ptf.py``'s workload (32,768 PTF-like tuples, seed
  1, 64 binary chunks, a 4,096-tuple synopsis): the same verdicts, the
  same stop, the same rounds; estimates to a relative 1e-5.
* ``make_ptf_like`` gives the reference's array bit for bit.
* ``variance_true`` and ``sample_size_for_accuracy`` on
  ``tests/test_estimators.py``'s Monte-Carlo design, to float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as JE
from repro.core import queries as jq
from repro.core.controller import EstimationController as JController
from repro.core.engine import EngineConfig as JConfig
from repro.data.generator import (
    make_ptf_like as j_ptf, make_synthetic_zipf, store_dataset as j_store)
from repro_torch.core import estimators as TE
from repro_torch.core import queries as tq
from repro_torch.core.controller import EstimationController as TController
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.data.generator import (
    make_ptf_like as t_ptf, store_dataset as t_store)

COEF = tuple(1.0 / (k + 1) for k in range(8))
RTOL = 1e-5


def chain_queries(q, truth):
    """test_controller_serve.py's chain: a pass, a fail, one never run."""
    return [
        q.Query(agg="sum", expr=q.Linear(COEF),
                having=q.Having("<", truth * 2), epsilon=0.05,
                name="q_pass"),
        q.Query(agg="sum", expr=q.Linear(COEF),
                having=q.Having("<", truth * 0.5), epsilon=0.05,
                name="q_fail"),
        q.Query(agg="count", pred=q.TRUE, having=q.Having(">", 0.0),
                epsilon=0.05, name="q_never"),
    ]


def ptf_queries(q):
    """examples/explore_ptf.py's three checks."""
    return [
        q.Query(agg="avg", expr=q.Column(4), pred=q.TRUE,
                having=q.Having("<", 0.05), epsilon=0.05,
                name="avg_mag_err<0.05"),
        q.Query(agg="count", pred=q.Range(3, 0.0, 17.0),
                having=q.Having(">", 500.0), epsilon=0.05,
                name="bright>500"),
        q.Query(agg="avg", expr=q.Column(3), pred=q.TRUE,
                having=q.Having("<", 22.0), epsilon=0.05,
                name="avg_mag<22"),
    ]


def _compare(tres, jres):
    assert len(tres) == len(jres)
    for a, b in zip(tres, jres):
        assert np.array_equal(a.decisions, b.decisions)
        assert np.array_equal(a.stopped, b.stopped)
        assert (a.rounds, a.from_synopsis) == (b.rounds, b.from_synopsis)
        np.testing.assert_allclose(a.tuples_ratio, b.tuples_ratio, rtol=0)
        for f in ("final_estimate", "final_err", "t_model_total"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, err_msg=f)


def _run(controller, config, store, queries, **kw):
    return controller(store, config, **kw).run_verification(queries)


def test_verification_chain_matches_reference():
    vals = make_synthetic_zipf(4096, 8, seed=3)
    truth = float(vals @ np.asarray(COEF) @ np.ones(len(vals)))
    jres = _run(JController, JConfig(num_workers=2, seed=1),
                j_store(vals, 32, "ascii"), chain_queries(jq, truth))
    tres = _run(TController, TConfig(num_workers=2, seed=1),
                t_store(vals, 32, "ascii"), chain_queries(tq, truth),
                device="cpu")
    _compare(tres, jres)
    assert len(tres) == 2                    # stopped after the failing one
    assert [int(r.decisions[0]) for r in tres] == [1, 0]


@pytest.mark.parametrize("synopsis", [0, 4096])
def test_explore_ptf_workload_matches_reference(synopsis):
    """explore_ptf.py's batch (binary records, so the ``ref`` extraction
    path), with and without the synopsis its controller keeps."""
    values = j_ptf(num_tuples=32768, num_chunks_hint=64, seed=1)
    cfg = dict(num_workers=4, strategy="resource_aware", seed=3)
    jres = _run(JController, JConfig(**cfg),
                j_store(values, 64, "binary"), ptf_queries(jq),
                synopsis_budget_tuples=synopsis)
    tres = _run(TController, TConfig(extract_backend="ref", **cfg),
                t_store(values, 64, "binary"), ptf_queries(tq),
                synopsis_budget_tuples=synopsis, device="cpu")
    _compare(tres, jres)
    # every verdict is the float64 truth's
    for q, r in zip(ptf_queries(tq), tres):
        plan = tq.linear_plan([q], 8)
        sel = np.all((values >= plan.lo[0]) & (values < plan.hi[0]), 1)
        x = values @ plan.coeffs[0].astype(np.float64)
        exact = {"count": sel.sum(), "avg": x[sel].mean()}[q.agg]
        op, thr = q.having.op, q.having.threshold
        truth = {"<": exact < thr, ">": exact > thr}[op]
        assert int(r.decisions[0]) in (-1, int(truth))


def test_verification_rejects_a_query_without_having():
    vals = make_synthetic_zipf(256, 8, seed=3)
    ctrl = TController(t_store(vals, 4, "ascii"), TConfig(num_workers=2),
                       device="cpu")
    with pytest.raises(ValueError, match="HAVING"):
        ctrl.run_verification([tq.Query(agg="count")])


@pytest.mark.parametrize("args", [(131_072, 128, 0), (32_768, 64, 1),
                                  (1000, 7, 5)])
def test_make_ptf_like_matches_reference(args):
    want = j_ptf(*args)
    got = t_ptf(*args)
    assert got.shape == want.shape == (args[0], 8)
    assert np.array_equal(got, want)


def test_variance_true_and_sample_size_match_reference():
    rng = np.random.default_rng(7)
    n, mj, nn, mm = 12, 24, 5, 8
    data = rng.normal(1.0, 1.0, (n, mj)) * (1 + np.arange(n))[:, None] * 0.2
    y = data.sum(1).astype(np.float32)
    ss = ((data - data.mean(1, keepdims=True)) ** 2).sum(1).astype(
        np.float32)
    want = float(JE.variance_true(jnp.asarray(y), jnp.asarray(ss),
                                  jnp.full((n,), mj), nn,
                                  jnp.full((n,), mm)))
    got = TE.variance_true(torch.as_tensor(y), torch.as_tensor(ss),
                           torch.full((n,), mj), nn, torch.full((n,), mm))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    est = np.array([1e3, -250.0, 0.0, 4e6], np.float32)
    var = np.array([4e2, 1e3, 5.0, 1e9], np.float32)
    m_used = np.array([100, 0, 10, 5000], np.int32)
    for eps, conf in ((0.05, 0.95), (0.01, 0.99), (0.5, 0.9)):
        want = np.asarray(JE.sample_size_for_accuracy(
            jnp.asarray(est), jnp.asarray(var), jnp.asarray(m_used), eps,
            conf))
        got = TE.sample_size_for_accuracy(
            torch.as_tensor(est), torch.as_tensor(var),
            torch.as_tensor(m_used), eps, conf).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL)
