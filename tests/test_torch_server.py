"""Port parity: the workload server against the JAX package's, on the
workload of ``examples/serve_ola_workload.py`` (16,384 tuples x 8 columns
in 64 ASCII chunks, 4 workers, seed 7, 4 slots, a 4,096-tuple synopsis;
five queries arriving mid-scan).

Per query the plan, rounds resident, tuples seen, seeded tuples and HAVING
decision must match, as must the server's round count, tuples scanned and
top-up passes.  Estimates agree to a relative 1e-5: the same float32 terms,
summed per round in another order.  A second workload drives a census (the
scan exhausts the table) with top-up passes.
"""

import numpy as np
import pytest
import torch

from repro.core import queries as jq
from repro.core.engine import EngineConfig as JConfig
from repro.data.generator import make_synthetic_zipf, store_dataset as j_store
from repro.serve import ola_server as js
from repro_torch.core import queries as tq
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.data.generator import store_dataset as t_store
from repro_torch.serve import ola_server as ts

RTOL = 1e-5


def _workload(mod, values):
    coef = tuple(1.0 / (k + 1) for k in range(8))
    exact_sum = float((values @ np.asarray(coef)).sum())
    return [
        (mod.Query(agg="sum", expr=mod.Linear(coef), epsilon=0.05,
                   name="sum-all"), 0.0),
        (mod.Query(agg="count", pred=mod.Range(0, 0.0, 4e7), epsilon=0.08,
                   name="count-sel"), 0.0005),
        (mod.Query(agg="sum", expr=mod.Linear(coef),
                   pred=mod.Range(0, 0.0, 6e7),
                   having=mod.Having("<", exact_sum), epsilon=0.05,
                   name="having-verify"), 0.001),
        (mod.Query(agg="avg", expr=mod.Linear(coef), epsilon=0.05,
                   name="avg-all"), 0.0015),
        (mod.Query(agg="sum", expr=mod.Linear(coef), epsilon=0.03,
                   name="sum-tight"), 0.002),
    ]


@pytest.fixture(scope="module")
def example():
    values = make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)
    return values, j_store(values, 64, "ascii"), t_store(values, 64, "ascii")


def _run(mod, store, cfg, opts, workload, **kw):
    server = mod.OLAWorkloadServer(store, cfg, options=opts, **kw)
    for q, at in workload:
        server.submit(q, arrival_t=at)
    return server, server.run()


def _compare(jsrv, jres, tsrv, tres):
    assert (tsrv.rounds, tsrv.tuples_scanned, tsrv.topup_passes) == (
        jsrv.rounds, jsrv.tuples_scanned, jsrv.topup_passes)
    assert len(tres) == len(jres)
    for a, b in zip(tres, jres):
        for f in ("qid", "name", "plan", "rounds_resident", "tuples_seen",
                  "seeded_tuples", "decision", "from_synopsis", "unserved",
                  "sched_outcome"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for f in ("estimate", "lo", "hi", "err", "t_admit", "t_done"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, err_msg=f"{a.name}: {f}")


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_example_workload_matches_reference(example, backend):
    values, jstore, tstore = example
    jsrv, jres = _run(js, jstore, JConfig(num_workers=4, seed=7),
                      js.ServerOptions(max_slots=4,
                                       synopsis_budget_tuples=4096),
                      _workload(jq, values))
    tsrv, tres = _run(ts, tstore,
                      TConfig(num_workers=4, seed=7, extract_backend=backend),
                      ts.ServerOptions(max_slots=4,
                                       synopsis_budget_tuples=4096),
                      _workload(tq, values), device="cpu")
    _compare(jsrv, jres, tsrv, tres)
    assert any(r.seeded_tuples > 0 for r in tres)        # mid-scan seeding
    assert any(r.from_synopsis for r in tres)            # answered at admit
    snap = tsrv.metrics_snapshot()
    assert snap["server_rounds"] == tsrv.rounds
    for r in tres:
        assert r.explain.final_estimate == r.estimate
        assert len(r.explain.trajectory) == r.rounds_resident


def test_census_with_topup_matches_reference():
    """Exact-answer (chunk-level) and tight queries on a small store run the
    scan to exhaustion: top-up passes, then census retirement."""
    values = make_synthetic_zipf(num_tuples=1536, num_cols=4, seed=2)
    jstore, tstore = j_store(values, 12, "ascii"), t_store(values, 12,
                                                           "ascii")
    work = []
    for mod in (jq, tq):
        work.append([
            (mod.Query(agg="sum", expr=mod.Column(0), epsilon=0.3,
                       name="loose"), 0.0),
            (mod.Query(agg="count", pred=mod.Range(1, 0.0, 2e7),
                       epsilon=0.0, name="exact"), 0.0004),
            (mod.Query(agg="avg", expr=mod.Column(2), epsilon=1e-4,
                       name="tight"), 0.0008),
        ])
    opts = dict(max_slots=2, synopsis_budget_tuples=256)
    jsrv, jres = _run(js, jstore, JConfig(num_workers=2, seed=3),
                      js.ServerOptions(**opts), work[0])
    tsrv, tres = _run(ts, tstore, TConfig(num_workers=2, seed=3),
                      ts.ServerOptions(**opts), work[1], device="cpu")
    _compare(jsrv, jres, tsrv, tres)
    assert tsrv.tuples_scanned == tstore.num_tuples
    assert tsrv.topup_passes >= 1


def test_select_plan_matches_reference(example):
    values, jstore, tstore = example
    for eps in (0.0, 0.05):
        for kw in (dict(), dict(io_bytes_per_sec=1e6),
                   dict(cpu_tuple_ops_per_sec=1e14)):
            jp = js.select_plan(jstore, JConfig(**kw),
                                jq.Query("sum", epsilon=eps))
            tp = ts.select_plan(tstore, TConfig(**kw),
                                tq.Query("sum", epsilon=eps))
            assert tp == jp
    rates = dict(io_bytes_per_sec=2e9, cpu_tuples_per_sec=5e6, workers=2,
                 cost_per_tuple=1000.0)
    assert ts.select_plan(tstore, TConfig(), tq.Query("sum"),
                          rates=ts.MeasuredRates(**rates)) == js.select_plan(
        jstore, JConfig(), jq.Query("sum"), rates=js.MeasuredRates(**rates))


def test_poisson_workload_matches_reference():
    qs = [tq.Query("sum", name=str(i)) for i in range(6)]
    want = [t for _, t in js.poisson_workload(qs, 20.0, seed=11)]
    got = [t for _, t in ts.poisson_workload(qs, 20.0, seed=11)]
    assert got == want


def test_server_defaults_to_cuda_and_unported_options_raise(example):
    _, _, tstore = example
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.OLAWorkloadServer(tstore, TConfig())
    for name in ("scheduler", "rollup", "mesh", "engine"):
        with pytest.raises(NotImplementedError):
            ts.OLAWorkloadServer(tstore, TConfig(),
                                 ts.ServerOptions(**{name: object()}),
                                 device="cpu")
    srv = ts.OLAWorkloadServer(tstore, TConfig(),
                               ts.ServerOptions(synopsis_budget_tuples=0),
                               device="cpu")
    with pytest.raises(ValueError):
        srv.submit(tq.Query("sum", expr=tq.SquaredDiff(0, 1)))
    with pytest.raises(ValueError):
        srv.submit(tq.Query("sum"), plan="fastest")
