"""Port parity: the workload server against the JAX package's, on the
workload of ``examples/serve_ola_workload.py`` (16,384 tuples x 8 columns
in 64 ASCII chunks, 4 workers, seed 7, 4 slots, a 4,096-tuple synopsis;
five queries arriving mid-scan).

Per query the plan, rounds resident, tuples seen, seeded tuples and HAVING
decision must match, as must the server's round count, tuples scanned and
top-up passes.  Estimates agree to a relative 1e-5: the same float32 terms,
summed per round in another order.  A second workload drives a census (the
scan exhausts the table) with top-up passes.  The measured-rates loader
and the legacy keyword surface are checked against the reference's cases.
"""

import dataclasses

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
    """Without a card the constructor raises unless the caller asks for the
    CPU; an injected ``engine`` is refused as the reference refuses it
    (built over another store, or without the extraction cache that
    synopsis seeding needs) and otherwise served on, its config, slot
    count and device winning; ``scheduler`` and ``rollup`` are accepted (a
    config or a built object).  ``mesh`` runs in tests/test_torch_spmd.py
    (it needs a process group)."""
    _, _, tstore = example
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.OLAWorkloadServer(tstore, TConfig())
    from repro_torch.core.engine import SlotOLAEngine

    other = SlotOLAEngine(t_store(values_small(), 4, "ascii"), 3,
                          TConfig(cache_cap=16), device="cpu")
    with pytest.raises(ValueError, match="different store"):
        ts.OLAWorkloadServer(tstore, TConfig(),
                             ts.ServerOptions(engine=other), device="cpu")
    uncached = SlotOLAEngine(tstore, 3, TConfig(), device="cpu")
    with pytest.raises(ValueError, match="extraction cache"):
        ts.OLAWorkloadServer(tstore, TConfig(),
                             ts.ServerOptions(engine=uncached), device="cpu")
    mine = SlotOLAEngine(tstore, 3, TConfig(num_workers=2, cache_cap=16),
                         device="cpu")
    srv = ts.OLAWorkloadServer(tstore, TConfig(),
                               ts.ServerOptions(engine=mine))
    assert srv.engine is mine and srv.config is mine.config
    assert srv.max_slots == 3 and srv.device == torch.device("cpu")
    srv.submit(tq.Query("sum", expr=tq.Column(1), epsilon=0.1),
               arrival_t=0.0)
    (res,) = srv.run()
    assert res.tuples_seen > 0 and np.isfinite(res.estimate)
    from repro_torch.sched import SchedulerConfig, WorkloadScheduler
    from repro_torch.serve.rollup import RollupConfig, RollupTier
    for sched, rollup in ((SchedulerConfig(), RollupConfig()),
                          (WorkloadScheduler(), RollupTier(tstore))):
        srv = ts.OLAWorkloadServer(
            tstore, TConfig(),
            ts.ServerOptions(scheduler=sched, rollup=rollup), device="cpu")
        assert isinstance(srv.scheduler, WorkloadScheduler)
        assert isinstance(srv.rollup, RollupTier)
        snap = srv.metrics_snapshot()
        assert snap["rollup_cells"] == 0
        assert snap['admission_decisions{action="shed"}'] == 0
    with pytest.raises(ValueError, match="different store"):
        ts.OLAWorkloadServer(
            tstore, TConfig(), ts.ServerOptions(
                rollup=RollupTier(t_store(values_small(), 4, "ascii"))),
            device="cpu")
    srv = ts.OLAWorkloadServer(tstore, TConfig(),
                               ts.ServerOptions(synopsis_budget_tuples=0),
                               device="cpu")
    with pytest.raises(ValueError):
        srv.submit(tq.Query("sum", expr=tq.SquaredDiff(0, 1)))
    with pytest.raises(ValueError):
        srv.submit(tq.Query("sum"), plan="fastest")


def values_small():
    return make_synthetic_zipf(num_tuples=256, num_cols=8, seed=1)


# ---------------------------------------------------------------------------
# Measured rates and the legacy keyword surface
# ---------------------------------------------------------------------------

CALIBRATIONS = [
    '{"calibration": {"backend": "ref", "cpu_tuples_per_sec": 1e12, '
    '"io_bytes_per_sec": 1e3}}',
    '{"calibration": {"backend": "cuda", "workers": 4, '
    '"cpu_tuples_per_sec": 2e9, "io_bytes_per_sec": 5e8, '
    '"cost_per_tuple": 700.0}}',
    '{"workers": 8, "calibration": {"cpu_tuples_per_sec": 1e6, '
    '"io_bytes_per_sec": 1e8, "round_base_us": 3000.0, '
    '"round_slot_us": 250.0}}',
    '{"calibration": {"backend": "ref", "cpu_tuples_per_sec": 1e6, '
    '"io_bytes_per_sec": 1e8, "round_base_us": NaN, '
    '"round_slot_us": -4.0, "cost_per_tuple": NaN}}',
    '{"calibration": {"cpu_tuples_per_sec": 0}}',
    '{"calibration": {"cpu_tuples_per_sec": NaN, "io_bytes_per_sec": 1e6}}',
    '{"calibration": {"io_bytes_per_sec": 1e6}}',
    '{"no_calibration": 1}',
    'not json',
]


@pytest.mark.parametrize("payload", range(len(CALIBRATIONS)))
def test_load_measured_rates_matches_reference(example, tmp_path, payload):
    """test_ola_server.py's loader cases: the same MeasuredRates (or None)
    from the same file, and the same plan choices on them."""
    values, jstore, tstore = example
    path = tmp_path / "cal.json"
    path.write_text(CALIBRATIONS[payload])
    want = js.load_measured_rates(str(path))
    got = ts.load_measured_rates(str(path))
    assert (got is None) == (want is None)
    if want is None:
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for kw in (dict(num_workers=1), dict(num_workers=8),
               dict(num_workers=128)):
        assert ts.select_plan(tstore, TConfig(**kw), tq.Query("sum"),
                              rates=got) == js.select_plan(
            jstore, JConfig(**kw), jq.Query("sum"), rates=want)


def test_rates_path_and_default_path(example, tmp_path, monkeypatch):
    """``ServerOptions.rates_path`` loads a calibration (a missing file
    keeps the modeled constants); the default path is this package's
    calibration file at the repo root, never the JAX package's
    ``BENCH_slot_kernel.json`` (whose calibration is a CPU run), whatever
    the working directory; ``OLA_RATES_PATH`` overrides it."""
    import os

    _, _, tstore = example
    path = tmp_path / "cal.json"
    path.write_text(CALIBRATIONS[2])
    srv = ts.OLAWorkloadServer(tstore, TConfig(num_workers=2),
                               ts.ServerOptions(rates_path=str(path)),
                               device="cpu")
    assert srv.rates.round_slot_us == 250.0
    srv = ts.OLAWorkloadServer(
        tstore, TConfig(num_workers=2),
        ts.ServerOptions(rates_path=str(tmp_path / "nope.json")),
        device="cpu")
    assert srv.rates is None

    monkeypatch.delenv("OLA_RATES_PATH", raising=False)
    monkeypatch.chdir(tmp_path)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    default = ts.default_rates_path()
    assert default == os.path.join(repo_root, "BENCH_torch_slot_kernel.json")
    assert os.path.basename(default) != "BENCH_slot_kernel.json"
    assert os.path.basename(js.default_rates_path()) == \
        "BENCH_slot_kernel.json"
    if not os.path.exists(default):
        assert ts.load_measured_rates() is None
    monkeypatch.setenv("OLA_RATES_PATH", str(path))
    assert ts.default_rates_path() == str(path)
    assert ts.load_measured_rates().round_base_us == 3000.0


def test_legacy_keywords_warn_once_and_reject_unknown(example, monkeypatch):
    import warnings

    _, _, tstore = example
    monkeypatch.setattr(ts, "_legacy_kwargs_warned", False)
    with pytest.warns(DeprecationWarning, match="ServerOptions"):
        srv = ts.OLAWorkloadServer(tstore, TConfig(num_workers=2),
                                   device="cpu", max_slots=2)
    assert srv.max_slots == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        srv = ts.OLAWorkloadServer(tstore, TConfig(num_workers=2),
                                   device="cpu", max_slots=3,
                                   synopsis_budget_tuples=0)
    assert srv.max_slots == 3 and srv.synopsis is None
    with pytest.raises(TypeError, match="max_slotz"):
        ts.OLAWorkloadServer(tstore, TConfig(), device="cpu", max_slotz=2)
    with pytest.raises(TypeError, match="not both"):
        ts.OLAWorkloadServer(tstore, TConfig(),
                             ts.ServerOptions(max_slots=2), device="cpu",
                             max_slots=2)
