"""Port parity: the Tier-1 rollup answer cache (``repro_torch.serve.rollup``
and the server's rollup path) against the JAX package's, on the CPU.

Every scenario of ``tests/test_rollup.py``: pattern keys, the cell fold,
the miner's promotion, LRU eviction, cold demotion and invalidation
compared exactly (both packages are numpy there); the server scenarios on
the same 4,096-tuple, 32-chunk store (seed 3) with the same per-query
outcomes, round counts, tier counters and cell sample sizes, float
estimates to a relative 1e-5.  A grouped run adds the per-group cell
mining and the grouped admission rules (never Tier-1, never evicted).
The kept quarantine difference is pinned for a promoted cell's birth seed.
"""

import dataclasses

import numpy as np
import pytest

from repro import sched as jsched
from repro.core import queries as jq
from repro.core.engine import EngineConfig as JConfig
from repro.data.generator import (
    make_synthetic_zipf, make_wiki_like, store_dataset as j_store)
from repro.serve import ola_server as js
from repro.serve import rollup as jr
from repro_torch import sched as tsched
from repro_torch.core import engine as t_eng
from repro_torch.core import queries as tq
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.data.generator import store_dataset as t_store
from repro_torch.serve import ola_server as ts
from repro_torch.serve import rollup as tr

COEF = tuple(1.0 / (k + 1) for k in range(8))
RTOL = 1e-5
PKGS = {"ref": (jq, jsched, js, jr, JConfig, j_store, {}),
        "port": (tq, tsched, ts, tr, TConfig, t_store,
                 dict(device="cpu"))}


@pytest.fixture(scope="module")
def vals():
    return make_synthetic_zipf(4096, 8, seed=3)


def _hot(q, name, epsilon=0.08, hi=6e7):
    return q.Query(agg="sum", expr=q.Linear(COEF), pred=q.Range(0, 0.0, hi),
                   epsilon=epsilon, name=name)


def _truth(vals, hi=6e7):
    sel = (vals[:, 0] >= 0.0) & (vals[:, 0] < hi)
    return float((vals @ np.asarray(COEF)) @ sel)


# ---------------------------------------------------------------------------
# Keys, cells, miner: exact
# ---------------------------------------------------------------------------

def test_pattern_key_matches_reference():
    def keys(q, r):
        return [r.pattern_key(_hot(q, "a", epsilon=0.08), 8),
                r.pattern_key(_hot(q, "b", epsilon=0.01), 8),
                r.pattern_key(dataclasses.replace(_hot(q, "c"),
                                                  confidence=0.99), 8),
                r.pattern_key(_hot(q, "d", hi=7e7), 8),
                r.pattern_key(q.Query(agg="count",
                                      pred=q.Range(0, 0.0, 6e7)), 8),
                r.pattern_key(q.Query(agg="sum", expr=q.Column(2),
                                      pred=q.Cmp(1, "<=", 3e7)), 8),
                r.pattern_key(q.Query(agg="sum", expr=q.Custom(
                    lambda c: c[..., 0] ** 2)), 8)]
    want, got = keys(jq, jr), keys(tq, tr)
    assert got == want
    a, b, c, d, count, cmp_, weird = got
    assert a is not None and a == b == c
    assert d != a and count != a and cmp_ is not None and weird is None


def test_cell_fold_matches_reference():
    rng = np.random.default_rng(2)
    cells = [r.RollupCell(key=("k",), query=_hot(q, "q"), n_chunks=6,
                          now=0.0, content_version=0)
             for q, r in ((jq, jr), (tq, tr))]
    for _ in range(20):
        row = dict(m=rng.integers(0, 9, 6),
                   ysum=rng.normal(size=6).astype(np.float32),
                   ysq=rng.random(6).astype(np.float32),
                   psum=rng.random(6))
        assert cells[1].fold(dict(row)) == cells[0].fold(dict(row))
        for f in ("m", "ysum", "ysq", "psum"):
            assert np.array_equal(getattr(cells[1], f),
                                  getattr(cells[0], f)), f
    assert cells[1].folds == cells[0].folds
    sizes = np.full(6, 8)
    assert np.array_equal(cells[1].covered(sizes), cells[0].covered(sizes))
    seed = cells[1].seed_dict()
    seed["m"][0] = -1                       # a copy, not a view
    assert cells[1].m[0] >= 0


def _miner_trace(q, r, store, cfg):
    tier = r.RollupTier(store, cfg)
    out = []
    for t, hi in enumerate([5e7, 5e7, 6e7, 5e7, 7e7, 6e7, 6e7, 8e7, 5e7]):
        qq = _hot(q, f"q{t}", hi=hi)
        cell = tier.observe(qq, r.pattern_key(qq, 8), now=float(t))
        out.append((cell is not None, sorted(
            (k[2], c.last_hit_t) for k, c in tier.cells.items())))
        tier.maintain(now=float(t) + 0.5)
    out.append(tier.counters())
    return out


@pytest.mark.parametrize("cfg", [
    dict(promote_hits=3), dict(promote_hits=1, max_cells=1),
    dict(promote_hits=2, max_cells=2, cold_after_s=2.0),
    dict(promote_hits=2, mine_window=3)])
def test_miner_and_maintenance_match_reference(vals, cfg):
    traces = [_miner_trace(q, r, st(vals, 32, "ascii"), r.RollupConfig(**cfg))
              for q, _, _, r, _, st, _ in PKGS.values()]
    assert traces[1] == traces[0]


def test_invalidation_matches_reference(vals):
    out = []
    for q, _, _, r, _, st, _ in PKGS.values():
        store = st(vals, 32, "ascii")
        tier = r.RollupTier(store, r.RollupConfig(promote_hits=1))
        qq = _hot(q, "q")
        key = r.pattern_key(qq, 8)
        cell = tier.observe(qq, key, now=0.0)
        cell.fold(dict(m=np.ones(32, np.int64), ysum=np.ones(32),
                       ysq=np.ones(32), psum=np.ones(32)))
        other = _hot(q, "o", hi=9e7)
        tier.observe(other, r.pattern_key(other, 8), now=0.0)
        dropped = tier.invalidate_chunks([3])
        store.mark_content_changed()
        tier.maintain(now=1.0)
        out.append((dropped, tier.get(key) is None, tier.counters(),
                    tier.observe(qq, key, now=2.0) is not None))
    assert out[1] == out[0]
    assert out[1][:2] == (1, True)
    for bad in (dict(promote_hits=0), dict(max_cells=0),
                dict(mine_window=0)):
        with pytest.raises(ValueError):
            tr.RollupConfig(**bad)


def test_slot_stats_fold_matches_snapshot(vals):
    srv = ts.OLAWorkloadServer(
        t_store(vals, 32, "ascii"), TConfig(num_workers=2, seed=5),
        options=ts.ServerOptions(max_slots=3), device="cpu")
    srv.submit(_hot(tq, "a", epsilon=0.02, hi=5e7), arrival_t=0.0)
    srv.submit(_hot(tq, "b", epsilon=0.02, hi=7e7), arrival_t=0.0)
    for _ in range(3):
        srv.step()
    ids = [s for s in range(3) if srv.slot_wq[s] is not None]
    assert ids
    batched = t_eng.slot_stats_fold(srv.state, ids)
    for s in ids:
        single = t_eng.slot_stats_snapshot(srv.state, s)
        for k in ("m", "ysum", "ysq", "psum"):
            np.testing.assert_array_equal(batched[s][k], single[k])
    assert t_eng.slot_stats_fold(srv.state, []) == {}
    srv.close()


# ---------------------------------------------------------------------------
# Server scenarios of tests/test_rollup.py, both packages
# ---------------------------------------------------------------------------

def _serve(pkg, vals, first, repeat, *, rollup=True, sched=None,
           synopsis=4096, mutate=False):
    """Serve ``first`` (two or more queries), then ``repeat``: the results,
    the server's facts and the cells' sample sizes."""
    q, S, srv_mod, r, Config, st, kw = PKGS[pkg]
    store = st(vals, 32, "ascii")
    opts = dict(max_slots=4, synopsis_budget_tuples=synopsis,
                rollup=r.RollupConfig(promote_hits=2) if rollup else None)
    if sched is not None:
        opts["scheduler"] = S.WorkloadScheduler(S.SchedulerConfig(**sched))
    srv = srv_mod.OLAWorkloadServer(store, Config(num_workers=2, seed=5),
                                    options=srv_mod.ServerOptions(**opts),
                                    **kw)
    for qq in first(q):
        srv.submit(qq, arrival_t=0.0)
    srv.run()
    before = (srv.rounds, srv.tuples_scanned)
    cells = ({k[2]: c.m.copy() for k, c in srv.rollup.cells.items()}
             if rollup else {})
    if mutate:
        store.mark_content_changed()
    for qq in repeat(q):
        srv.submit(qq)
    res = sorted(srv.run(), key=lambda x: x.qid)
    facts = dict(before=before, after=(srv.rounds, srv.tuples_scanned),
                 counters=srv.rollup.counters() if rollup else None)
    srv.close()
    return res, facts, cells


SCENARIOS = {
    "hot-repeat": (lambda q: [_hot(q, "r0"), _hot(q, "r1")],
                   lambda q: [_hot(q, "r2")], {}),
    "census": (lambda q: [_hot(q, "c0", 1e-9), _hot(q, "c1", 1e-9)],
               lambda q: [_hot(q, "c2", 1e-9)], {}),
    "partial": (lambda q: [_hot(q, "p0", 0.10), _hot(q, "p1", 0.10)],
                lambda q: [_hot(q, "p2", 0.10)], {}),
    "tighter": (lambda q: [_hot(q, "s0", 0.10), _hot(q, "s1", 0.10)],
                lambda q: [_hot(q, "s2", 1e-9)], {}),
    "content-change": (lambda q: [_hot(q, "v0"), _hot(q, "v1")],
                       lambda q: [_hot(q, "v2")], dict(mutate=True)),
    "scheduled": (lambda q: [_hot(q, "t0"), _hot(q, "t1")],
                  lambda q: [_hot(q, "t2"), _hot(q, "t3", 1e-9)],
                  dict(sched=dict(slot_capacity=2.0))),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rollup_server_matches_reference(vals, name):
    first, repeat, kw = SCENARIOS[name]
    (jres, jf, jcells), (tres, tf, tcells) = (
        _serve(p, vals, first, repeat, **kw) for p in ("ref", "port"))
    assert tf == jf
    assert tcells.keys() == jcells.keys()
    for k in jcells:
        assert np.array_equal(tcells[k], jcells[k])
    assert len(tres) == len(jres)
    for a, b in zip(tres, jres):
        for f in ("qid", "name", "plan", "sched_outcome", "rounds_resident",
                  "tuples_seen", "seeded_tuples", "decision",
                  "from_synopsis", "unserved"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for f in ("estimate", "lo", "hi", "err", "t_admit", "t_done"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, err_msg=f"{a.name}: {f}")
    last = tres[-1] if name != "scheduled" else tres[-2]
    truth = _truth(vals)
    # test_rollup.py's own gates on the port's run
    if name in ("hot-repeat", "partial", "census", "scheduled"):
        assert last.sched_outcome == "tier1" and last.plan == "rollup"
        assert last.rounds_resident == 0
        assert tf["after"] == tf["before"] or name == "scheduled"
    if name in ("hot-repeat", "partial", "scheduled"):
        assert last.lo <= truth <= last.hi
    if name == "census":
        assert last.err == 0.0 and last.tuples_seen == 4096
        np.testing.assert_allclose(last.estimate, truth, rtol=1e-5)
    if name == "partial":
        assert last.err > 0.0
    if name == "tighter":
        (m,) = tcells.values()
        assert last.sched_outcome != "tier1"
        assert last.seeded_tuples >= int(m.sum())
    if name == "content-change":
        assert last.sched_outcome != "tier1"
        assert tf["counters"]["invalidations"] == 1


def test_census_cell_equals_fresh_scan_bitwise(vals):
    """A fully covered cell answers exactly: the port's Tier-1 answer is
    bit for bit the port's fresh census scan of the pattern."""
    res, _, cells = _serve("port", vals,
                           lambda q: [_hot(q, "c0", 1e-9),
                                      _hot(q, "c1", 1e-9)],
                           lambda q: [_hot(q, "c2", 1e-9)])
    (m,) = cells.values()
    store = t_store(vals, 32, "ascii")
    assert np.array_equal(m, store.chunk_sizes)
    fresh = ts.OLAWorkloadServer(
        store, TConfig(num_workers=2, seed=5),
        options=ts.ServerOptions(max_slots=4, synopsis_budget_tuples=0),
        device="cpu")
    fresh.submit(_hot(tq, "ref", 1e-9), arrival_t=0.0)
    (ref,) = fresh.run()
    fresh.close()
    assert res[-1].sched_outcome == "tier1"
    assert res[-1].estimate == ref.estimate


# ---------------------------------------------------------------------------
# Grouped queries beside the tier: cell mining, no Tier-1, no eviction
# ---------------------------------------------------------------------------

def _grouped_run(pkg, values):
    q, S, srv_mod, r, Config, st, kw = PKGS[pkg]
    store = st(values, 12, "ascii", uneven=True)
    srv = srv_mod.OLAWorkloadServer(
        store, Config(num_workers=2, seed=7, max_groups=4),
        options=srv_mod.ServerOptions(
            max_slots=2, synopsis_budget_tuples=0,
            rollup=r.RollupConfig(promote_hits=1),
            scheduler=S.WorkloadScheduler(S.SchedulerConfig(
                slot_capacity=1.0, preempt=True))), **kw)
    gq = q.Query(agg="sum", expr=q.Linear((0.0, 1.0, 0.0, 0.0)),
                 epsilon=0.1, name="g",
                 group_by=q.GroupBy(col=0, max_groups=4, top_k=3))
    srv.submit(gq, arrival_t=0.0, slo=S.QuerySLO(priority="batch"))
    srv.submit(dataclasses.replace(gq, name="g2"), arrival_t=0.0,
               slo=S.QuerySLO(priority="batch"))
    # an interactive deadline behind two grouped residents: preemption may
    # not take a grouped slot
    srv.submit(q.Query(agg="sum", expr=q.Column(1), epsilon=0.2, name="i"),
               arrival_t=1e-6,
               slo=S.QuerySLO(priority="interactive", deadline_s=1e-3))
    # a later repeat of the grouped query finds its pattern promoted and
    # still never takes Tier-1
    srv.submit(dataclasses.replace(gq, name="g3"), arrival_t=1.0,
               slo=S.QuerySLO(priority="batch"))
    res = sorted(srv.run(), key=lambda x: x.qid)
    out = ([(x.name, x.sched_outcome, x.rounds_resident, x.tuples_seen,
             len(x.groups or [])) for x in res], srv.rounds,
           srv.preempt_count, srv.rollup.counters(),
           sorted(int(c.m.sum()) for c in srv.rollup.cells.values()))
    srv.close()
    return out


def test_grouped_rollup_mining_matches_reference():
    values, _ = make_wiki_like(4096, num_languages=8, seed=0)
    want, got = _grouped_run("ref", values), _grouped_run("port", values)
    assert got == want
    outcomes = {name: oc for name, oc, *_ in got[0]}
    assert outcomes["g3"] != "tier1" and got[2] == 0
    assert got[3]["promotions"] > 1          # per-group fan-out cells


# ---------------------------------------------------------------------------
# The kept quarantine difference: a promoted cell's birth seed
# ---------------------------------------------------------------------------

def test_birth_seed_after_quarantining_a_cached_chunk_differs_from_reference(
        vals, monkeypatch):
    """A chunk is quarantined after the scan cached a window of it, then a
    pattern is promoted: the reference birth-seeds the new cell from a
    synopsis that re-absorbed the chunk's window; the port masks it out of
    the birth seed.  Every other column of the two birth seeds is the
    same.  A scheduled shed preview is masked in both packages alike."""
    out = {}
    for pkg in ("ref", "port"):
        q, S, srv_mod, r, Config, st, kw = PKGS[pkg]
        folds = []
        fold = r.RollupCell.fold

        def record(cell, row, _fold=fold, _out=folds):
            _out.append((id(cell), np.asarray(row["m"]).copy()))
            return _fold(cell, row)

        monkeypatch.setattr(r.RollupCell, "fold", record)
        srv = srv_mod.OLAWorkloadServer(
            st(vals, 32, "ascii"), Config(num_workers=2, seed=5),
            options=srv_mod.ServerOptions(
                max_slots=2, synopsis_budget_tuples=4096,
                rollup=r.RollupConfig(promote_hits=2),
                scheduler=S.WorkloadScheduler(S.SchedulerConfig())), **kw)
        # the first completion of the pattern leaves the scan's windows in
        # the extraction cache; then a cached chunk is lost
        srv.submit(_hot(q, "warm", 0.5), arrival_t=0.0)
        srv.run()
        scan_m = np.asarray(srv.state.scan_m.cpu() if pkg == "port"
                            else srv.state.scan_m)
        lost = int(np.flatnonzero(scan_m)[0])
        srv.quarantine([lost])
        # the second completion promotes the pattern: its cell is born from
        # the synopsis, refreshed at this admission
        srv.submit(_hot(q, "again", 0.5))
        srv.run()
        (cell,) = srv.rollup.cells.values()
        birth = next(m for c, m in folds if c == id(cell))
        t_full = 4096 / srv._scan_rate
        srv.submit(q.Query(agg="count", pred=q.Range(0, 0.0, 6e7),
                           epsilon=1e-4, name="shed"),
                   slo=S.QuerySLO(deadline_s=t_full * 1e-6))
        res = {x.name: x for x in srv.run()}
        # the synopsis row the shed preview was priced from (no round ran
        # since that intake's refresh)
        seed_m = np.asarray(srv.synopsis.seed_slot(
            q.Query(agg="count", pred=q.Range(0, 0.0, 6e7)))["m"])
        out[pkg] = (lost, birth, res["shed"], seed_m)
        srv.close()
    (lost, jm, jshed, jseed), (lost_p, tm, tshed, tseed) = (out["ref"],
                                                            out["port"])
    assert lost == lost_p
    assert jm[lost] > 0 and tm[lost] == 0        # the known difference
    others = np.arange(len(tm)) != lost
    assert np.array_equal(tm[others], jm[others])
    # both synopses re-absorbed the lost window; both previews drop it
    for shed, seed in ((jshed, jseed), (tshed, tseed)):
        assert seed[lost] > 0
        assert shed.sched_outcome == "shed"
        assert shed.tuples_seen == int(seed.sum()) - int(seed[lost]) > 0
