"""Port parity: the SLO scheduler (``repro_torch.sched`` and the server's
scheduled path) against the JAX package's, on the CPU.

* Policy units, compared exactly (both packages are numpy here):
  ``max_min_weights``, the admission decisions, ``variance_claim_order``'s
  bands (and the port's one-copy read of a tensor state), ``P2Quantile``,
  the service model, ``select_victim`` and ``measured_slot_capacity``.
* Every server scenario of ``tests/test_sched.py`` but the SPMD one, on the
  same 4,096-tuple, 32-chunk store (seed 3): the same per-query
  ``sched_outcome``, ``slo_met``, ``rounds_resident``, ``tuples_seen`` and
  ``decision``, the same round count and integer engine state after every
  round; float estimates to a relative 1e-5 (the same float32 terms summed
  in another order).
* Inside the port, bit for bit: the NEUTRAL scheduler equals the
  unscheduled server (packed and stream), and the scheduled stream equals
  the scheduled packed run under both claim policies.
* A card test runs the scheduled workload of ``chip_smoke.py``'s
  ``[sched-parity]`` phase on the card against the CPU.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.core import queries as jq
from repro.core.engine import EngineConfig as JConfig
from repro.data.generator import make_synthetic_zipf, store_dataset as j_store
from repro.sched import admission as j_adm
from repro.serve import ola_server as js
from repro_torch import sched as tsched
from repro_torch.core import queries as tq
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.data.generator import store_dataset as t_store
from repro_torch.sched import admission as t_adm
from repro_torch.serve import ola_server as ts

COEF = tuple(1.0 / (k + 1) for k in range(8))
RTOL = 1e-5

REF = SimpleNamespace(q=jq, sched=jsched, srv=js, Config=JConfig,
                      store=j_store, kw={})
PORT = SimpleNamespace(q=tq, sched=tsched, srv=ts, Config=TConfig,
                       store=t_store, kw=dict(device="cpu"))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def vals():
    return make_synthetic_zipf(4096, 8, seed=3)


# ---------------------------------------------------------------------------
# Policy units: exact
# ---------------------------------------------------------------------------

def _weight_cases():
    cases = [
        ([1.0] * 4, [True, True, True, False], math.inf),
        ([1.0] * 4, [True, True, True, False], 3.0),
        ([1.0] * 4, [True, True, True, False], 1.5),
        ([1.0, 4.0], [True, True], 1.0),
        ([1.0, 100.0], [True, True], 1.5),
        ([1.0, 2.0, 4.0], [True] * 3, 2.0),
    ]
    rng = np.random.default_rng(5)
    for _ in range(40):
        s = int(rng.integers(1, 9))
        cases.append((rng.choice([1.0, 2.0, 4.0], s).tolist(),
                      (rng.random(s) < 0.7).tolist(),
                      float(rng.choice([0.5, 1.0, 2.5, 4.0, math.inf]))))
    return cases


def test_max_min_weights_matches_reference():
    for pri, act, cap in _weight_cases():
        want = jsched.max_min_weights(np.array(pri), np.array(act), cap)
        got = tsched.max_min_weights(np.array(pri), np.array(act), cap)
        assert np.array_equal(got, want), (pri, act, cap)
    for mod in (jsched, tsched):
        with pytest.raises(ValueError):
            mod.max_min_weights(np.array([0.0, 1.0]), np.ones(2, bool), 1.0)


def _decide_cases(mod):
    load_free = mod.ServerLoad(now=0.0, free_slots=1, queue_ahead=0,
                               scan_rate=1000.0, total_tuples=1000)
    load_busy = dataclasses.replace(load_free, free_slots=0)
    busy2 = mod.ServerLoad(now=0.0, free_slots=0, queue_ahead=2,
                           scan_rate=1000.0, total_tuples=10_000)
    priced = dataclasses.replace(busy2, slot_drain_s=0.25,
                                 queue_ahead_service_s=1.0)
    tight = mod.QuerySLO(deadline_s=0.1)
    slo5 = mod.QuerySLO(deadline_s=5.0)
    out = [
        (dict(), dict(slo=mod.QuerySLO(), load=load_free)),
        (dict(), dict(slo=mod.QuerySLO(), load=load_busy)),
        (dict(), dict(slo=tight, load=load_free)),
        (dict(), dict(slo=tight, load=load_free, seed_m=500,
                      seed_err=0.052)),
        (dict(shed_enabled=False), dict(slo=tight, load=load_busy)),
        (dict(), dict(slo=slo5, load=busy2, seed_m=5000, seed_err=0.051)),
        (dict(), dict(slo=slo5, load=priced, seed_m=5000, seed_err=0.051)),
        (dict(), dict(slo=slo5, load=load_free, rollup_err=0.01)),
        (dict(pessimism=2.0), dict(slo=slo5, load=busy2, group_count=5)),
    ]
    rng = np.random.default_rng(9)
    for _ in range(40):
        load = mod.ServerLoad(
            now=float(rng.uniform(0, 2)), free_slots=int(rng.integers(0, 3)),
            queue_ahead=int(rng.integers(0, 3)),
            scan_rate=float(rng.uniform(1e2, 1e4)),
            total_tuples=int(rng.integers(1000, 50_000)),
            mean_service_s=float(rng.choice([0.0, rng.uniform(0.1, 5)])),
            slot_drain_s=(None if rng.random() < 0.5
                          else float(rng.uniform(0, 3))))
        slo = mod.QuerySLO(
            deadline_s=float(rng.choice([math.inf, rng.uniform(0.5, 30)])),
            priority=str(rng.choice(["batch", "normal", "interactive"])))
        out.append((dict(shed_enabled=bool(rng.random() < 0.8)), dict(
            slo=slo, load=load, seed_m=int(rng.integers(0, 5000)),
            seed_err=float(rng.uniform(0.01, 0.3)),
            rollup_err=float(rng.choice([math.inf, rng.uniform(0, 0.2)])),
            group_count=int(rng.choice([0, 5])))))
    return out


def test_admission_decisions_match_reference():
    rt_j = jsched.AdmissionController.required_tuples
    rt_t = tsched.AdmissionController.required_tuples
    for args in [(0, math.inf, 0.05, 10_000), (100, 0.02, 0.05, 10_000),
                 (100, 0.10, 0.05, 10_000), (100, 0.10, 0.001, 200)]:
        assert rt_t(*args) == rt_j(*args)
    models = []
    for mod in (jsched, tsched):
        model = mod.ServiceTimeModel(quantile=0.9, min_samples=4)
        for x in (0.5, 0.7, 3.0, 0.2, 9.0, 0.4):
            model.observe("normal", x)
        models.append(model)
    for with_model in (False, True):
        decided = []
        for mod, model in zip((jsched, tsched), models):
            out = []
            for ctor, call in _decide_cases(mod):
                ac = mod.AdmissionController(
                    service_model=model if with_model else None, **ctor)
                out.append(ac.decide(arrival_t=0.05, epsilon=0.05,
                                     **call).as_dict())
                out.append(dict(ac.decisions))
            decided.append(out)
        assert decided[1] == decided[0]
    assert {t_adm.ADMIT, t_adm.QUEUE, t_adm.SHED, t_adm.TIER1} == {
        j_adm.ADMIT, j_adm.QUEUE, j_adm.SHED, j_adm.TIER1}


def _claim_states():
    """test_sched.py's claim-order states and random ones:
    ``(state, sizes, slot_need)``."""
    n = 8
    schedule = np.array([5, 2, 7, 0, 1, 3, 6, 4], np.int32)
    m = np.zeros((2, n))
    ys = np.zeros((2, n))
    yq = np.zeros((2, n))
    m[:, [0, 1]] = 10
    ys[0, 0], yq[0, 0] = 10.0, 11.0
    ys[0, 1], yq[0, 1] = 10.0, 110.0
    out = [(SimpleNamespace(
        stats=SimpleNamespace(m=m, ysum=ys, ysq=yq),
        scan_m=np.array([10, 10, 0, 0, 0, 0, 0, 64]),
        closed=np.array([False] * 7 + [True]), head=2, schedule=schedule),
        np.full(n, 64), None)]
    out.append((SimpleNamespace(
        stats=SimpleNamespace(m=np.zeros((2, n)), ysum=ys * 0, ysq=yq * 0),
        scan_m=np.zeros(n, int), closed=np.zeros(n, bool), head=0,
        schedule=schedule), np.full(n, 64), None))
    m2, ys2, yq2 = np.zeros((2, 4)), np.zeros((2, 4)), np.zeros((2, 4))
    m2[:, [0, 1]] = 10
    ys2[0, 0], yq2[0, 0] = 10.0, 200.0
    ys2[1, 1], yq2[1, 1] = 10.0, 60.0
    out.append((SimpleNamespace(
        stats=SimpleNamespace(m=m2, ysum=ys2, ysq=yq2),
        scan_m=np.array([10, 10, 0, 0]), closed=np.zeros(4, bool), head=2,
        schedule=np.array([2, 3, 0, 1], np.int32)), np.full(4, 64),
        np.array([0.0, 3.0])))
    rng = np.random.default_rng(17)
    for _ in range(30):
        s, n = int(rng.integers(1, 5)), int(rng.integers(2, 24))
        sizes = rng.integers(4, 64, n)
        scan_m = np.where(rng.random(n) < 0.6,
                          rng.integers(0, 65, n), 0).clip(0, sizes)
        mm = np.minimum(rng.integers(0, 40, (s, n)), scan_m[None])
        ysum = (rng.normal(size=(s, n)) * mm).astype(np.float32)
        ysq = (np.abs(rng.normal(size=(s, n))) * 3 * mm
               + ysum.astype(np.float64) ** 2 / np.maximum(mm, 1)
               ).astype(np.float32)
        state = SimpleNamespace(
            stats=SimpleNamespace(m=mm.astype(np.int32), ysum=ysum,
                                  ysq=ysq),
            scan_m=scan_m.astype(np.int32),
            closed=rng.random(n) < 0.2, head=int(rng.integers(0, n)),
            schedule=rng.permutation(n).astype(np.int32))
        need = None if rng.random() < 0.4 else rng.uniform(0, 3, s)
        out.append((state, sizes, need))
    return out


def _tensor_state(state):
    t = torch.as_tensor
    st = state.stats
    return SimpleNamespace(
        stats=SimpleNamespace(m=t(np.asarray(st.m, np.int32)),
                              ysum=t(np.asarray(st.ysum, np.float32)),
                              ysq=t(np.asarray(st.ysq, np.float32))),
        scan_m=t(np.asarray(state.scan_m, np.int32)),
        closed=t(np.asarray(state.closed, bool)),
        head=t(np.int32(state.head)),
        schedule=t(np.asarray(state.schedule, np.int32)))


def test_variance_claim_order_matches_reference():
    """The same orders and variance keys as the reference on numpy states,
    and on the same state held as tensors (read in one copy)."""
    reordered = 0
    for state, sizes, need in _claim_states():
        want = jsched.variance_claim_order(state, sizes, slot_need=need)
        for st in (state, _tensor_state(state)):
            got = tsched.variance_claim_order(st, sizes, slot_need=need)
            assert (got is None) == (want is None)
            if want is not None:
                assert got.dtype == np.int32
                assert np.array_equal(got, want)
            np.testing.assert_array_equal(
                tsched.slot_chunk_variances(st, slot_need=need),
                jsched.slot_chunk_variances(state, slot_need=need))
        reordered += want is not None
    assert reordered >= 10
    bad = _claim_states()[2][0]
    for mod in (jsched, tsched):
        with pytest.raises(ValueError):
            mod.slot_chunk_variances(bad, slot_need=np.ones(3))


def test_p2_quantile_and_service_model_match_reference():
    for p, seed, draw in [(0.9, 0, "lognormal"), (0.5, 1, "lognormal"),
                          (0.9, 2, "exponential"), (0.75, 3, "uniform")]:
        xs = getattr(np.random.default_rng(seed), draw)(size=2000)
        a, b = jsched.P2Quantile(p), tsched.P2Quantile(p)
        assert a.value() is None and b.value() is None
        for x in xs:
            a.observe(x)
            b.observe(x)
            assert b.value() == a.value()
    for mod in (jsched, tsched):
        with pytest.raises(ValueError):
            mod.P2Quantile(1.0)
    models = [mod.ServiceTimeModel(quantile=0.9, min_samples=4)
              for mod in (jsched, tsched)]
    rng = np.random.default_rng(4)
    for _ in range(60):
        cls = str(rng.choice(["batch", "normal", "interactive"]))
        x = float(rng.choice([rng.lognormal(), float("nan"), -1.0]))
        prior = float(rng.uniform(0.1, 10))
        for model in models:
            model.observe(cls, x)
        got = [(mdl.predict(c, prior), mdl.n_obs(c)) for mdl in models
               for c in ("batch", "normal", "interactive", "other")]
        assert got[:4] == got[4:]


def test_select_victim_and_measured_capacity_match_reference():
    rng = np.random.default_rng(8)
    classes = ["batch", "normal", "interactive"]
    for _ in range(60):
        s = int(rng.integers(1, 7))
        picks = []
        for mod in (jsched, tsched):
            slos = [None if rng.random() < 0.2 else
                    mod.QuerySLO(priority=str(rng.choice(classes)))
                    for _ in range(s)]
            picks.append(slos)
        # the same draws for both packages
        slos_t = [None if x is None else tsched.QuerySLO(priority=x.priority)
                  for x in picks[0]]
        admit_t = rng.uniform(0, 5, s).tolist()
        ok = (rng.random(s) < 0.8).tolist()
        cand = str(rng.choice(classes))
        want = jsched.select_victim(
            jsched.QuerySLO(deadline_s=1.0, priority=cand), picks[0],
            admit_t, ok)
        got = tsched.select_victim(
            tsched.QuerySLO(deadline_s=1.0, priority=cand), slos_t,
            admit_t, ok)
        assert got == want
    for base, slot, head in [(3000.0, 300.0, 0.5), (3000.0, 300.0, 1.0),
                             (3000.0, 30000.0, 0.5), (3000.0, 0.0, 0.5),
                             (0.0, 300.0, 0.5), (float("nan"), 1.0, 0.5)]:
        rates = [mod.MeasuredRates(io_bytes_per_sec=5e8,
                                   cpu_tuples_per_sec=3e5,
                                   round_base_us=base, round_slot_us=slot)
                 for mod in (js, ts)]
        assert tsched.measured_slot_capacity(rates[1], head) == \
            jsched.measured_slot_capacity(rates[0], head)
    assert tsched.measured_slot_capacity(None) is None
    with pytest.raises(ValueError):
        tsched.measured_slot_capacity(ts.MeasuredRates(
            io_bytes_per_sec=5e8, cpu_tuples_per_sec=3e5,
            round_base_us=3000.0, round_slot_us=300.0), headroom=0.0)
    for bad in (dict(claim_policy="random"), dict(queue_policy="lifo"),
                dict(slot_capacity="guess"), dict(wait_quantile=1.0)):
        with pytest.raises(ValueError):
            tsched.SchedulerConfig(**bad)


# ---------------------------------------------------------------------------
# Server scenarios of tests/test_sched.py, both packages
# ---------------------------------------------------------------------------

TRACE_FIELDS = ("scan_m", "offset", "closed", "cur", "head", "schedule",
                "stopped")


def _server(P, store, cfg, **opts):
    return P.srv.OLAWorkloadServer(store, P.Config(**cfg),
                                   options=P.srv.ServerOptions(**opts),
                                   **P.kw)


def _record(trace):
    def on_round(srv):
        st = srv.state
        trace.append([_np(getattr(st, f)) for f in TRACE_FIELDS]
                     + [_np(st.stats.m), _np(srv.table.weight)])
    return on_round


def _sum(P, name, eps, **kw):
    return P.q.Query(agg="sum", expr=P.q.Linear(COEF), epsilon=eps,
                     name=name, **kw)


def _mixed(P):
    q = P.q
    return [
        (_sum(P, "a", 0.04), 0.0),
        (_sum(P, "b", 0.06, pred=q.Range(0, 0.0, 8e7)), 1e-5),
        (q.Query(agg="count", pred=q.Range(1, 0.0, 7e7), epsilon=0.08,
                 name="c"), 2e-5),
        (q.Query(agg="avg", expr=q.Linear(COEF), epsilon=0.07, name="d"),
         3e-5),
        (_sum(P, "e", 0.10), 4e-4),
    ]


def sc_neutral(P, store, trace, residency):
    srv = _server(P, store, dict(num_workers=2, seed=9, residency=residency),
                  max_slots=2)
    srv.scheduler = P.sched.WorkloadScheduler(P.sched.NEUTRAL)
    for q, at in _mixed(P):
        srv.submit(q, arrival_t=at)
    return srv, srv.run(on_round=_record(trace))


def _pressure(P, store, trace, slo, scheduler):
    srv = _server(P, store, dict(num_workers=2, seed=13), max_slots=1,
                  synopsis_budget_tuples=0, scheduler=scheduler)
    for i in range(3):
        srv.submit(_sum(P, f"long{i}", 0.02), arrival_t=0.0)
    srv.submit(_sum(P, "hot", 0.08), arrival_t=1e-6, slo=slo)
    return srv, srv.run(on_round=_record(trace))


def sc_pressure(P, store, trace, policy, deadline):
    """test_priority_pressure_meets_deadline: FIFO and the priority
    scheduler, first with no deadline, then with the deadline between the
    reference's two latencies."""
    slo = P.sched.QuerySLO(deadline_s=deadline, priority="interactive")
    sched = (P.sched.WorkloadScheduler(
        P.sched.SchedulerConfig(shed_enabled=False))
        if policy == "priority" else None)
    return _pressure(P, store, trace, slo, sched)


def _warm_then(P, store, trace, seed, late_query, late_slo, **opts):
    srv = _server(P, store, dict(num_workers=2, seed=seed), max_slots=2,
                  synopsis_budget_tuples=4096,
                  scheduler=P.sched.WorkloadScheduler(
                      P.sched.SchedulerConfig(**opts)))
    srv.submit(_sum(P, "warm", 0.04), arrival_t=0.0)
    srv.run(on_round=_record(trace))
    t_full = store.num_tuples / srv._scan_rate
    srv.submit(late_query, slo=late_slo(t_full))
    return srv, srv.run(on_round=_record(trace))


def sc_shed(P, store, trace):
    return _warm_then(P, store, trace, 17, _sum(P, "doomed", 0.001),
                      lambda t: P.sched.QuerySLO(deadline_s=t * 1e-6))


def sc_halfwidth(P, store, trace, truth):
    return _warm_then(P, store, trace, 37, _sum(P, "hw", 0.5),
                      lambda t: P.sched.QuerySLO(
                          deadline_s=t * 1e-6,
                          target_halfwidth=abs(truth) * 1e-3))


def _contended(P, store, trace, seed, rates=None, capacity=1.0):
    sc = P.sched.SchedulerConfig(slot_capacity=capacity, shed_enabled=False,
                                 claim_policy="schedule")
    opts = dict(max_slots=2, synopsis_budget_tuples=0,
                scheduler=P.sched.WorkloadScheduler(sc))
    if rates is not None:
        opts["measured_rates"] = P.srv.MeasuredRates(**rates)
    return _server(P, store, dict(num_workers=2, seed=seed), **opts)


def sc_fairness(P, store, trace):
    srv = _contended(P, store, trace, 19)
    srv.submit(_sum(P, "bat", 1e-6), arrival_t=0.0,
               slo=P.sched.QuerySLO(priority="batch"))
    srv.submit(_sum(P, "hot", 1e-6), arrival_t=0.0,
               slo=P.sched.QuerySLO(priority="interactive"))
    rec = _record(trace)
    for _ in range(4):
        srv.step()
        rec(srv)
    return srv, []


def sc_measured(P, store, trace):
    srv = _contended(P, store, trace, 47, capacity="measured", rates=dict(
        io_bytes_per_sec=5e8, cpu_tuples_per_sec=3e5, round_base_us=1000.0,
        round_slot_us=500.0))
    srv.submit(_sum(P, "a", 1e-6), arrival_t=0.0,
               slo=P.sched.QuerySLO(priority="batch"))
    srv.submit(_sum(P, "b", 1e-6), arrival_t=0.0,
               slo=P.sched.QuerySLO(priority="interactive"))
    rec = _record(trace)
    for _ in range(3):
        srv.step()
        rec(srv)
    return srv, []


def sc_churn(P, store, trace):
    srv = _contended(P, store, trace, 41)
    srv.submit(_sum(P, "a", 1e-6), arrival_t=0.0)
    srv.submit(P.q.Query(agg="count", pred=P.q.Range(0, 0.0, 1e12),
                         epsilon=0.5, name="b"), arrival_t=0.0)
    rec = _record(trace)
    srv.step()
    rec(srv)
    srv.submit(_sum(P, "c", 1e-6))
    for _ in range(6):
        srv.step()
        rec(srv)
    return srv, []


def _one_slot(P, store, seed, **opts):
    return _server(P, store, dict(num_workers=2, seed=seed), max_slots=1,
                   synopsis_budget_tuples=0,
                   scheduler=P.sched.WorkloadScheduler(
                       P.sched.SchedulerConfig(**opts)))


def sc_deadline(P, store, trace):
    srv = _one_slot(P, store, 23, shed_enabled=False)
    t_full = store.num_tuples / srv._scan_rate
    srv.submit(_sum(P, "boxed", 1e-9), arrival_t=0.0,
               slo=P.sched.QuerySLO(deadline_s=t_full * 0.25))
    return srv, srv.run(on_round=_record(trace))


def sc_zero_tuple(P, store, trace):
    srv = _one_slot(P, store, 31, shed_enabled=False)
    srv.submit(_sum(P, "census", 1e-9), arrival_t=0.0)
    srv.submit(_sum(P, "late", 0.05), arrival_t=0.0,
               slo=P.sched.QuerySLO(deadline_s=1e-12))
    return srv, srv.run(on_round=_record(trace))


def sc_quantile(P, store, trace):
    srv = _one_slot(P, store, 43)
    t_full = store.num_tuples / srv._scan_rate
    model = srv.scheduler.service_model
    for _ in range(9):
        model.observe("normal", 0.05 * t_full)
    for _ in range(3):
        model.observe("normal", 0.9 * t_full)
    mean_service = (9 * 0.05 + 3 * 0.9) / 12 * t_full
    srv._service_times = [0.05 * t_full] * 9 + [0.9 * t_full] * 3
    srv.submit(_sum(P, "hold", 1e-6), arrival_t=0.0)
    srv.step()
    srv.submit(_sum(P, "edge", 0.05),
               slo=P.sched.QuerySLO(deadline_s=t_full + mean_service * 2.0))
    return srv, srv.run(on_round=_record(trace))


def sc_preempt(P, store, trace, preempt, deadline_frac):
    srv = _one_slot(P, store, 51 if deadline_frac > 1e-3 else 53,
                    preempt=preempt)
    t_full = store.num_tuples / srv._scan_rate
    srv.submit(_sum(P, "bat", 1e-6), arrival_t=0.0,
               slo=P.sched.QuerySLO(priority="batch"))
    srv.submit(_sum(P, "hot", 0.08), arrival_t=t_full * 0.01,
               slo=P.sched.QuerySLO(deadline_s=t_full * deadline_frac,
                                    priority="interactive"))
    return srv, srv.run(on_round=_record(trace))


def sc_variance_topup(P, store, trace):
    srv = _server(P, store, dict(num_workers=2, seed=29), max_slots=2,
                  synopsis_budget_tuples=512,
                  scheduler=P.sched.WorkloadScheduler(
                      P.sched.SchedulerConfig(shed_enabled=False)))
    srv.submit(P.q.Query(agg="count", pred=P.q.Range(0, 0.0, 1e12),
                         epsilon=0.02, name="loose"),
               arrival_t=0.0, plan="single_pass")
    srv.run(on_round=_record(trace))
    srv.submit(_sum(P, "tight", 0.005), plan="single_pass")
    return srv, srv.run(on_round=_record(trace))


def _truth(vals):
    return float((vals @ np.asarray(COEF)).sum())


def _deadline_between(vals):
    """test_priority_pressure_meets_deadline's deadline: midway between the
    reference's latencies of the hot query under FIFO and priority."""
    store = j_store(vals, 32, "ascii")
    probe = jsched.QuerySLO(priority="interactive")
    lat = [{r.name: r for r in _pressure(REF, store, [], probe, s)[1]}[
        "hot"].latency for s in (None, jsched.WorkloadScheduler(
            jsched.SchedulerConfig(shed_enabled=False)))]
    return (lat[0] + lat[1]) / 2.0


SCENARIOS = {
    "neutral-packed": lambda P, st, tr, v: sc_neutral(P, st, tr, "packed"),
    "neutral-stream": lambda P, st, tr, v: sc_neutral(P, st, tr, "stream"),
    "pressure-fifo": lambda P, st, tr, v: sc_pressure(
        P, st, tr, "fifo", _deadline_between(v)),
    "pressure-priority": lambda P, st, tr, v: sc_pressure(
        P, st, tr, "priority", _deadline_between(v)),
    "shed": lambda P, st, tr, v: sc_shed(P, st, tr),
    "fairness": lambda P, st, tr, v: sc_fairness(P, st, tr),
    "deadline": lambda P, st, tr, v: sc_deadline(P, st, tr),
    "variance-topup": lambda P, st, tr, v: sc_variance_topup(P, st, tr),
    "zero-tuple": lambda P, st, tr, v: sc_zero_tuple(P, st, tr),
    "halfwidth": lambda P, st, tr, v: sc_halfwidth(P, st, tr, _truth(v)),
    "churn": lambda P, st, tr, v: sc_churn(P, st, tr),
    "quantile": lambda P, st, tr, v: sc_quantile(P, st, tr),
    "measured": lambda P, st, tr, v: sc_measured(P, st, tr),
    "preempt-on": lambda P, st, tr, v: sc_preempt(P, st, tr, True, 1.5),
    "preempt-off": lambda P, st, tr, v: sc_preempt(P, st, tr, False, 1.5),
    "preempt-hopeless": lambda P, st, tr, v: sc_preempt(P, st, tr, True,
                                                        1e-6),
}

INT_RESULT = ("qid", "name", "plan", "sched_outcome", "slo_met",
              "rounds_resident", "tuples_seen", "seeded_tuples", "decision",
              "from_synopsis", "unserved", "priority")
FLOAT_RESULT = ("estimate", "lo", "hi", "err", "t_admit", "t_done",
                "queue_wait")


def _run_both(name, vals):
    out = []
    for P in (REF, PORT):
        trace = []
        srv, res = SCENARIOS[name](P, P.store(vals, 32, "ascii"), trace,
                                   vals)
        facts = dict(rounds=srv.rounds, scanned=srv.tuples_scanned,
                     topups=srv.topup_passes, shed=srv.shed_count,
                     preempt=srv.preempt_count)
        srv.close()
        out.append((facts, sorted(res, key=lambda r: r.qid), trace))
    return out


def _compare(ref, port):
    (jf, jres, jtr), (tf, tres, ttr) = ref, port
    assert tf == jf
    assert len(tres) == len(jres)
    for a, b in zip(tres, jres):
        for f in INT_RESULT:
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for f in FLOAT_RESULT:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, err_msg=f"{a.name}: {f}")
    assert len(ttr) == len(jtr)
    names = TRACE_FIELDS + ("stats.m", "weight")
    for r, (x, y) in enumerate(zip(ttr, jtr)):
        for f, a, b in zip(names, x, y):
            assert np.array_equal(a, b), f"round {r}: {f}"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduled_server_matches_reference(vals, name):
    ref, port = _run_both(name, vals)
    _compare(ref, port)
    facts, res, trace = port
    by = {r.name: r for r in res}
    truth = _truth(vals)
    # the reference test's own gate, held by the port's run
    if name == "pressure-priority":
        assert by["hot"].slo_met is True
        assert by["hot"].sched_outcome == "queued"
    elif name == "pressure-fifo":
        assert by["hot"].slo_met is False
    elif name == "shed":
        d = by["doomed"]
        assert d.sched_outcome == "shed" and d.from_synopsis
        assert abs(d.estimate - truth) / truth < 0.2 and d.err > 0.001
        assert facts["shed"] == 1
    elif name == "fairness":
        np.testing.assert_allclose(trace[-1][-1], [0.8, 0.2], rtol=1e-5)
        m = trace[-1][-2].sum(axis=1).astype(float)
        assert 3.0 < m[0] / m[1] < 5.0
    elif name == "measured":
        np.testing.assert_allclose(trace[-1][-1], [0.8, 0.2], rtol=1e-5)
    elif name == "churn":
        np.testing.assert_allclose(trace[-1][-1], [0.5, 0.5])
    elif name == "deadline":
        (r,) = res
        assert r.tuples_seen < 4096 and r.slo_met is False
        assert abs(r.estimate - truth) / truth < 0.25
    elif name == "variance-topup":
        assert facts["topups"] >= 1
        assert abs(by["tight"].estimate - truth) / truth < 3 * 0.005
        assert any(not np.array_equal(t[TRACE_FIELDS.index("schedule")],
                                      trace[0][TRACE_FIELDS.index(
                                          "schedule")]) for t in trace)
    elif name == "zero-tuple":
        assert by["late"].unserved and by["late"].slo_met is False
    elif name == "halfwidth":
        assert by["hw"].sched_outcome == "shed"
    elif name == "quantile":
        assert by["edge"].sched_outcome == "shed"
    elif name == "preempt-on":
        assert facts["preempt"] == 1 and by["hot"].slo_met is True
        assert by["bat"].sched_outcome == "preempted"
        assert by["bat"].seeded_tuples > 0
    elif name == "preempt-off":
        assert facts["preempt"] == 0 and by["hot"].slo_met is False
    elif name == "preempt-hopeless":
        assert facts["preempt"] == 0
        assert by["hot"].sched_outcome == "shed"


# ---------------------------------------------------------------------------
# Bitwise gates inside the port
# ---------------------------------------------------------------------------

EXACT_RESULT = INT_RESULT + FLOAT_RESULT


def _port_run(vals, residency, scheduler, phases, synopsis=4096):
    """Serve ``phases`` (lists of ``(query, arrival_t, slo, plan)``, each
    submitted once the previous one has run out) on the port, on the CPU:
    ``(exact result tuples, per-round trace, rounds, tuples scanned)``."""
    store = t_store(vals, 32, "ascii")
    srv = ts.OLAWorkloadServer(
        store, TConfig(num_workers=2, seed=29, residency=residency),
        options=ts.ServerOptions(max_slots=2, scheduler=scheduler,
                                 synopsis_budget_tuples=synopsis),
        device="cpu")
    trace = []
    try:
        for phase in phases:
            for q, at, slo, plan in phase:
                srv.submit(q, arrival_t=at, slo=slo, plan=plan)
            srv.run(on_round=_record(trace))
        return ([tuple(getattr(r, f) for f in EXACT_RESULT)
                 for r in sorted(srv.results, key=lambda r: r.qid)],
                trace, srv.rounds, srv.tuples_scanned)
    finally:
        srv.close()


def _assert_same(a, b):
    assert a[2:] == b[2:]
    assert len(a[0]) == len(b[0])
    for x, y in zip(a[0], b[0]):
        assert all(u == v or (u != u and v != v)
                   for u, v in zip(x, y)), (x, y)
    assert len(a[1]) == len(b[1])
    for r, (x, y) in enumerate(zip(a[1], b[1])):
        for u, v in zip(x, y):
            assert np.array_equal(u, v), f"round {r}"


@pytest.mark.parametrize("residency", ["packed", "stream"])
def test_neutral_equals_unscheduled_bitwise(vals, residency):
    work = [[(q, at, None, None) for q, at in _mixed(PORT)]]
    base = _port_run(vals, residency, None, work)
    neutral = _port_run(vals, residency, tsched.WorkloadScheduler(
        tsched.NEUTRAL), work)
    _assert_same(neutral, base)


def _topup_phases(P):
    """test_sched.py's variance top-up workload with SLOs: a near-certain
    COUNT closes chunks early, then a tight SUM and two more queries drive
    the scan into a top-up pass under contention."""
    q, slo = P.q, P.sched.QuerySLO
    return [
        [(q.Query(agg="count", pred=q.Range(0, 0.0, 1e12), epsilon=0.02,
                  name="loose"), 0.0, None, "single_pass")],
        [(_sum(P, "tight", 0.005), None, slo(priority="interactive"),
          "single_pass"),
         (_sum(P, "bat", 0.01), None, slo(priority="batch"), None),
         (q.Query(agg="avg", expr=q.Linear(COEF), epsilon=0.01, name="d"),
          None, slo(priority="interactive", deadline_s=5e-3), None)],
    ]


@pytest.mark.parametrize("policy", ["schedule", "variance"])
def test_scheduled_stream_equals_packed_bitwise(vals, policy):
    """Under contention, preemption, a top-up pass and either claim policy
    the streamed scheduled run equals the packed one bit for bit: a slab
    read ahead under the old order still feeds its own chunk."""
    def sched():
        return tsched.WorkloadScheduler(tsched.SchedulerConfig(
            slot_capacity=1.0, preempt=True, claim_policy=policy))
    work = _topup_phases(PORT)
    packed = _port_run(vals, "packed", sched(), work)
    stream = _port_run(vals, "stream", sched(), work)
    _assert_same(stream, packed)
    trace = packed[1]
    assert (np.concatenate([t[-1] for t in trace]) < 1).any()
    i = TRACE_FIELDS.index("schedule")
    reordered = sum(not np.array_equal(t[i], trace[0][i]) for t in trace)
    assert (reordered > 0) == (policy == "variance")


# ---------------------------------------------------------------------------
# The card against the CPU ([sched-parity] of chip_smoke.py)
# ---------------------------------------------------------------------------

def _example_slo_workload(values):
    coef = tuple(1.0 / (k + 1) for k in range(8))
    exact_sum = float((values @ np.asarray(coef)).sum())
    slo = tsched.QuerySLO
    return [
        (tq.Query(agg="sum", expr=tq.Linear(coef), epsilon=0.05,
                  name="sum-all"), 0.0, slo(priority="batch")),
        (tq.Query(agg="count", pred=tq.Range(0, 0.0, 4e7), epsilon=0.08,
                  name="count-sel"), 0.0005, slo(priority="interactive")),
        (tq.Query(agg="sum", expr=tq.Linear(coef),
                  pred=tq.Range(0, 0.0, 6e7),
                  having=tq.Having("<", exact_sum), epsilon=0.05,
                  name="having-verify"), 0.001,
         slo(priority="interactive", deadline_s=0.05)),
        (tq.Query(agg="avg", expr=tq.Linear(coef), epsilon=0.05,
                  name="avg-all"), 0.0015, slo(priority="normal")),
        (tq.Query(agg="sum", expr=tq.Linear(coef), epsilon=0.03,
                  name="sum-tight"), 0.002, None),
    ]


F32_RTOL = 1e-5


def _keyed(sched):
    """Record every claim key ``sched`` computes (one per round)."""
    keys = []
    order = sched.claim_order

    def claim_order(state, sizes, active=None, slot_need=None):
        keys.append(tsched.slot_chunk_variances(state, active, slot_need))
        return order(state, sizes, active, slot_need)

    sched.claim_order = claim_order
    return keys


def first_divergence(a, b):
    """The first round whose integer state differs between two traces, or
    None when they agree and have one length."""
    for r, (x, y) in enumerate(zip(a, b)):
        for u, v in zip(x[:len(TRACE_FIELDS) + 1], y[:len(TRACE_FIELDS) + 1]):
            if not np.array_equal(u, v):
                return r
    return None if len(a) == len(b) else min(len(a), len(b))


def near_tie(r, trace_a, trace_b, keys_a, keys_b) -> tuple:
    """At divergence round ``r`` the two claim orders must differ, and the
    first two chunks they swap must have keys that agree within a float32
    relative tolerance in both runs.  Returns ``(position, chunk_a,
    chunk_b)``."""
    i = TRACE_FIELDS.index("schedule")
    sa, sb = trace_a[r][i], trace_b[r][i]
    if np.array_equal(sa, sb):
        raise AssertionError(f"round {r}: integer state diverged under the "
                             "same claim order")
    p = int(np.flatnonzero(sa != sb)[0])
    ja, jb = int(sa[p]), int(sb[p])
    for k in (keys_a[r], keys_b[r]):
        scale = max(abs(k[ja]), abs(k[jb]), 1e-30)
        assert abs(k[ja] - k[jb]) <= F32_RTOL * scale, (
            f"round {r}: chunks {ja} and {jb} swapped with keys "
            f"{k[ja]!r} and {k[jb]!r}: not a near tie")
    return p, ja, jb


def _card_case(case, device, sched, keys_vals):
    """``(results, trace)`` of one card-test workload on ``device``."""
    if case == "example":
        values = make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)
        store, cfg = t_store(values, 64, "ascii"), dict(num_workers=4, seed=7)
        phases = [[(q, at, slo, None)
                   for q, at, slo in _example_slo_workload(values)]]
    else:
        values = keys_vals
        store, cfg = t_store(values, 32, "ascii"), dict(num_workers=2,
                                                        seed=29)
        phases = _topup_phases(PORT)
    srv = ts.OLAWorkloadServer(
        store, TConfig(**cfg),
        options=ts.ServerOptions(max_slots=2, scheduler=sched),
        device=device)
    trace = []
    try:
        for phase in phases:
            for q, at, slo, plan in phase:
                srv.submit(q, arrival_t=at, slo=slo, plan=plan)
            srv.run(on_round=_record(trace))
        return (sorted(srv.results, key=lambda r: r.qid), trace, values,
                [x[0] for ph in phases for x in ph])
    finally:
        srv.close()


@pytest.mark.cuda
@pytest.mark.parametrize("policy,case", [("schedule", "example"),
                                         ("variance", "example"),
                                         ("variance", "topup")])
def test_scheduled_card_matches_cpu(vals, policy, case):
    """The scheduled workloads of chip_smoke.py's ``[sched-parity]``
    (fairness contention, preemption, deadlines, shedding; the top-up one
    reorders the claim tail) on the card against the CPU: integer state
    equal every round under ``claim_policy="schedule"``; under
    ``"variance"`` equal up to the first round whose claim orders differ,
    where the swapped chunks' keys must be a near tie, and from then on
    every answer that retired on its own within 3·ε of exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for dev in ("cuda", "cpu"):
        sched = tsched.WorkloadScheduler(tsched.SchedulerConfig(
            slot_capacity=1.0, preempt=True, claim_policy=policy))
        keys = _keyed(sched)
        runs[dev] = _card_case(case, dev, sched, vals) + (keys,)
    (cres, ctr, values, queries, ckeys) = runs["cuda"]
    (hres, htr, _, _, hkeys) = runs["cpu"]
    first = first_divergence(ctr, htr)
    if policy == "schedule" or first is None:
        assert first is None
        for a, b in zip(cres, hres, strict=True):
            for f in INT_RESULT:
                assert getattr(a, f) == getattr(b, f), (a.name, f)
        return
    near_tie(first, ctr, htr, ckeys, hkeys)
    by = {q.name: q for q in queries}
    for r in cres:
        q = by[r.name]
        if r.sched_outcome in ("admitted", "queued", "preempted") \
                and not r.unserved and r.err <= q.epsilon:
            plan = tq.linear_plan([q], 8)
            sel = np.all((values >= plan.lo[0]) & (values < plan.hi[0]), 1)
            x = values @ plan.coeffs[0].astype(np.float64)
            want = {"count": sel.sum(), "sum": x[sel].sum(),
                    "avg": x[sel].mean()}[q.agg]
            assert abs(r.estimate - want) <= 3 * q.epsilon * abs(want), (
                r.name)
