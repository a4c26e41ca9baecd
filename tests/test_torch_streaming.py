"""Port parity: streaming residency and the parse-once decoded cache, end to
end, against the JAX package on the CPU.

* Engines (``SlotOLAEngine`` with mid-scan admission, ``OLAEngine``) with
  ``residency="stream"``, cache off, on and at a budget that forces
  ``mixed`` rounds, run round for round beside the reference's stream
  engine (``extract_backend="ref"``): integer state identical every round,
  float statistics within a relative 1e-5 (the same float32 terms summed
  in another order).  Inside the port the stream rounds equal the packed
  rounds bit for bit, cache on or off.
* The workload server on ``examples/serve_ola_workload.py``'s workload
  with the cache off and on: the reference's per-query outcomes.
* A lost chunk (``FaultInjector``): the reference's quarantine, per-query
  outcomes, ``degraded``/``chunks_quarantined`` and the decoded-cache drop.

Every engine and server a test makes is closed, so no prefetcher reader
thread outlives its test.
"""

import numpy as np
import pytest
import torch

from repro.core import engine as j_eng
from repro.core import queries as jq
from repro.data import faults as jf
from repro.data.generator import make_synthetic_zipf, store_dataset as j_store
from repro.serve import ola_server as js
from repro_torch.core import engine as t_eng
from repro_torch.core import queries as tq
from repro_torch.data import faults as tf
from repro_torch.data.generator import store_dataset as t_store
from repro_torch.sampling.permutation import random_chunk_order
from repro_torch.serve import ola_server as ts

INT_FIELDS = ("scan_m", "offset", "closed", "acc_met", "head", "cur",
              "raw_touched", "stopped", "round", "cpu_bound", "first_est",
              "quarantined", "cached_m")
RTOL = 1e-5


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_states(t, j, where):
    for f in INT_FIELDS:
        assert np.array_equal(_np(getattr(t, f)), _np(getattr(j, f))), (
            f"{where}: {f}")
    assert np.array_equal(_np(t.stats.m), _np(j.stats.m)), f"{where}: m"
    for f in ("ysum", "ysq", "psum"):
        np.testing.assert_allclose(_np(getattr(t.stats, f)),
                                   _np(getattr(j.stats, f)), rtol=RTOL,
                                   atol=1e-3, err_msg=f"{where}: {f}")
    for f in ("t_io", "t_cpu", "budget"):
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   rtol=RTOL, err_msg=f"{where}: {f}")
    np.testing.assert_array_equal(_np(t.cache), _np(j.cache),
                                  err_msg=f"{where}: cache")


def _assert_bitwise(a, b, where):
    for f in ("scan_m", "offset", "closed", "cur", "head"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{where}: {f}"
    for f in ("m", "ysum", "ysq", "psum"):
        assert torch.equal(getattr(a.stats, f), getattr(b.stats, f)), (
            f"{where}: {f}")
    for f in ("cache", "t_io", "t_cpu", "budget"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{where}: {f}"


def _queries(mod, c=8):
    coef = tuple(1.0 / (k + 1) for k in range(c))
    return [
        mod.Query(agg="sum", expr=mod.Linear(coef),
                  pred=mod.Range(0, 0.0, 6e7), epsilon=0.04, name="s"),
        mod.Query(agg="count", pred=mod.Range(1, 0.0, 7e7), epsilon=0.05,
                  name="c"),
        mod.Query(agg="avg", expr=mod.Linear(coef), epsilon=0.05, name="a"),
        mod.Query(agg="sum", expr=mod.Column(1),
                  having=mod.Having(">", 1e9), epsilon=0.02, name="h"),
    ]


@pytest.fixture(scope="module")
def values():
    return make_synthetic_zipf(4096, 8, seed=3)


def _block_bytes(store):
    return int(store.max_chunk_tuples) * store.codec.num_cols * 4


# decoded-cache budgets: off, all chunks, and three chunks' blocks (evicts
# and leaves some workers raw while others hit: mixed rounds)
CACHES = {"off": lambda st: 0, "on": lambda st: 1 << 26,
          "tiny": lambda st: 3 * _block_bytes(st)}


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("cache", sorted(CACHES))
def test_slot_engine_stream_round_for_round(values, cache, backend):
    plans = ("single_pass", "resource_aware", "holistic", "chunk_level")
    jstore = j_store(values, 24, "ascii", uneven=True, seed=3)
    tstore = t_store(values, 24, "ascii", uneven=True, seed=3)
    dec = CACHES[cache](tstore)
    kw = dict(num_workers=3, seed=5, cache_cap=64, budget_init=32)
    je = j_eng.SlotOLAEngine(jstore, 5, j_eng.EngineConfig(
        residency="stream", decoded_cache_bytes=dec, **kw))
    te = t_eng.SlotOLAEngine(tstore, 5, t_eng.EngineConfig(
        residency="stream", decoded_cache_bytes=dec,
        extract_backend=backend, **kw), device="cpu")
    tp = t_eng.SlotOLAEngine(tstore, 5, t_eng.EngineConfig(
        extract_backend=backend, **kw), device="cpu")
    try:
        jt = jq.empty_slot_table(5, 8)
        tt = tq.empty_slot_table(5, 8, device="cpu")
        pairs = list(zip(_queries(jq), _queries(tq)))
        jst, tst, pst = je.init_state(), te.init_state(), tp.init_state()
        admit_at = {0: [0, 1], 4: [2], 9: [3]}        # mid-scan admissions
        modes = []
        for r in range(60):
            for s in admit_at.get(r, []):
                jt = jq.slot_table_set(jt, s, jq.encode_slot(
                    pairs[s][0], 8, plan=plans[s]))
                tt = tq.slot_table_set(tt, s, tq.encode_slot(
                    pairs[s][1], 8, plan=plans[s]))
            b = te.budget_ladder(float(tst.budget))
            assert b == je.budget_ladder(float(jst.budget))
            jst, jdata = je.round_data(jst)
            jmode, jdata = je.data_mode(jdata)
            tst, tdata = te.round_data(tst)
            tmode, tdata = te.data_mode(tdata)
            assert tmode == jmode, f"round {r}: variant"
            modes.append(tmode)
            jst, jrep = je.round_fn(b, jmode)(jst, jt, jdata, je.speeds)
            tst, trep = te.round_fn(b, tmode)(tst, tt, tdata, te.speeds)
            pst, _ = tp.round_fn(b)(pst, tt, tp.packed, tp.speeds)
            _assert_states(tst, jst, f"round {r}")
            _assert_bitwise(tst, pst, f"round {r} stream vs packed")
            assert np.array_equal(_np(trep.decided), _np(jrep.decided))
            if bool(jrep.exhausted):
                break
        want = {"off": {"none"}, "on": {"mixed", "all"},
                "tiny": {"mixed"}}[cache]
        assert want <= set(modes), modes
        assert te.decoded_fraction() == je.decoded_fraction()
    finally:
        je.close()
        te.close()
        tp.close()


@pytest.mark.parametrize("cache,fmt", [("off", "ascii"), ("on", "ascii"),
                                       ("on", "binary")])
def test_frozen_engine_stream_matches_reference(values, cache, fmt):
    """Binary records decode for the cache through the codec's plain
    decode (``extract_parse`` is the ASCII kernel); the binary engine runs
    the ``ref`` backend, as the reference requires."""
    jstore = j_store(values, 16, fmt)
    tstore = t_store(values, 16, fmt)
    dec = CACHES[cache](tstore)
    kw = dict(num_workers=4, strategy="resource_aware", seed=7,
              residency="stream", decoded_cache_bytes=dec,
              extract_backend="ref")
    if fmt == "ascii":
        tkw = dict(kw, extract_backend="cuda")    # the port's fused path
    else:
        tkw = kw
    je = j_eng.OLAEngine(jstore, _queries(jq)[:3],
                         j_eng.EngineConfig(**kw))
    te = t_eng.OLAEngine(tstore, _queries(tq)[:3], t_eng.EngineConfig(**tkw),
                         device="cpu")
    try:
        jst, jhist = je.run(max_rounds=400)
        tst, thist = te.run(max_rounds=400)
        assert len(thist) == len(jhist)
        for r, (a, b) in enumerate(zip(thist, jhist)):
            for f in ("n_chunks", "m_tuples", "all_stopped", "exhausted",
                      "tuples_round"):
                assert np.array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f))), (r, f)
            np.testing.assert_allclose(np.asarray(a.estimate),
                                       np.asarray(b.estimate), rtol=RTOL)
        _assert_states(tst, jst, "final")
        if cache == "on":
            assert te.pipeline.decoded_hits > 0
            assert te.pipeline.decoded_hits == je.pipeline.decoded_hits
    finally:
        je.close()
        te.close()


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
    """examples/serve_ola_workload.py's table: 16,384 tuples x 8 columns in
    64 ASCII chunks."""
    return make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)


SERVER_INT_FIELDS = ("scan_m", "offset", "closed", "cur", "head",
                     "quarantined", "stopped")


def _serve(mod, store, cfg, workload, retry, **kw):
    srv = mod.OLAWorkloadServer(
        store, cfg, options=mod.ServerOptions(max_slots=4,
                                              synopsis_budget_tuples=4096),
        **kw)
    trace = []

    def on_round(server):
        st = server.state
        trace.append([_np(getattr(st, f)) for f in SERVER_INT_FIELDS]
                     + [_np(st.stats.m)])

    try:
        srv.engine.pipeline.retry = retry
        for q, at in workload:
            srv.submit(q, arrival_t=at)
        res = srv.run(on_round=on_round)
        pf = srv.engine.pipeline
        facts = dict(rounds=srv.rounds, scanned=srv.tuples_scanned,
                     topups=srv.topup_passes,
                     quarantined=srv.chunks_quarantined,
                     qlog=list(srv.engine.quarantine_log),
                     decoded=sorted(j for j in range(store.num_chunks)
                                    if pf.decoded is not None
                                    and j in pf.decoded),
                     snapshot=srv.metrics_snapshot(), trace=trace)
        return facts, res
    finally:
        srv.close()
        assert not srv.engine.pipeline._reader.is_alive()


def _compare_traces(t, j):
    """Integer engine state after every server round."""
    assert len(t) == len(j)
    for r, (a, b) in enumerate(zip(t, j)):
        for f, x, y in zip(SERVER_INT_FIELDS + ("stats.m",), a, b):
            assert np.array_equal(x, y), f"round {r}: {f}"


def _compare_results(tres, jres):
    assert len(tres) == len(jres)
    for a, b in zip(tres, jres):
        for f in ("qid", "name", "plan", "rounds_resident", "tuples_seen",
                  "seeded_tuples", "decision", "from_synopsis", "unserved",
                  "degraded", "chunks_quarantined", "read_retries"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for f in ("estimate", "lo", "hi", "err", "t_admit", "t_done"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=RTOL, err_msg=f"{a.name}: {f}")


@pytest.mark.parametrize("cache", ["off", "on"])
def test_server_stream_matches_reference(example, cache):
    jstore, tstore = j_store(example, 64, "ascii"), t_store(example, 64,
                                                            "ascii")
    dec = CACHES[cache](tstore)
    kw = dict(num_workers=4, seed=7, residency="stream",
              decoded_cache_bytes=dec)
    jf_, jres = _serve(js, jstore, j_eng.EngineConfig(**kw),
                       _workload(jq, example), jf.RetryPolicy())
    tf_, tres = _serve(ts, tstore, t_eng.EngineConfig(**kw),
                       _workload(tq, example), tf.RetryPolicy(),
                       device="cpu")
    _compare_results(tres, jres)
    _compare_traces(tf_["trace"], jf_["trace"])
    for k in ("rounds", "scanned", "topups", "decoded"):
        assert tf_[k] == jf_[k], k
    assert bool(tf_["decoded"]) == (cache == "on")
    assert tf_["snapshot"]["prefetch_slabs_built"] == tf_["rounds"]
    assert tf_["snapshot"]["quarantine_log"] == []


@pytest.mark.parametrize("cache", ["off", "on"])
def test_lost_chunk_quarantine_matches_reference(example, cache):
    """A chunk the scan claims early is lost for good: both servers
    quarantine it on its first read, answer over the survivors and flag
    every later answer degraded; the decoded cache never holds it."""
    lost = int(np.asarray(random_chunk_order(7, 64))[5])
    kw = dict(num_workers=4, seed=7, residency="stream")
    facts = []
    for mod, eng, faults, store_fn, dev in (
            (js, j_eng, jf, j_store, {}),
            (ts, t_eng, tf, t_store, dict(device="cpu"))):
        store = faults.FaultInjector(store_fn(example, 64, "ascii"),
                                     faults.FaultConfig(seed=7,
                                                        lost_chunks=(lost,)))
        cfg = eng.EngineConfig(
            decoded_cache_bytes=CACHES[cache](store), **kw)
        mod_q = jq if mod is js else tq
        retry = faults.RetryPolicy(max_attempts=2, sleep=lambda s: None)
        facts.append(_serve(mod, store, cfg, _workload(mod_q, example),
                            retry, **dev))
    (tf_, tres), (jf_, jres) = facts[1], facts[0]
    _compare_results(tres, jres)
    _compare_traces(tf_["trace"], jf_["trace"])
    assert tf_["qlog"] == jf_["qlog"] == [lost]
    assert tf_["quarantined"] == 1
    assert lost not in tf_["decoded"]
    assert tf_["decoded"] == jf_["decoded"]
    assert any(r.degraded for r in tres)
    assert tf_["snapshot"]["server_chunks_quarantined"] == 1
    assert tf_["snapshot"]['faults_injected{kind="lost"}'] >= 1


def test_manual_quarantine_drops_decoded_and_reprices(example):
    store = t_store(example, 64, "ascii")
    cfg = t_eng.EngineConfig(num_workers=4, seed=7, residency="stream",
                             decoded_cache_bytes=1 << 26)
    srv = ts.OLAWorkloadServer(store, cfg, device="cpu")
    try:
        for q, at in _workload(tq, example)[:3]:
            srv.submit(q, arrival_t=at)
        srv.run()
        pf = srv.engine.pipeline
        cached = sorted(j for j in range(64) if j in pf.decoded)
        assert cached
        rate, frac = srv._scan_rate, pf.decoded_fraction()
        srv.quarantine([cached[0]])
        assert cached[0] not in pf.decoded
        assert pf.decoded_fraction() < frac
        assert srv._scan_rate != rate
        assert srv.chunks_quarantined == 1
        assert srv.metrics_snapshot()["quarantine_log"] == [cached[0]]
        st = srv.state
        assert bool(st.quarantined[cached[0]]) and bool(st.closed[cached[0]])
        assert not st.stats.m[:, cached[0]].any()
        srv.quarantine([cached[0]])                  # idempotent
        assert srv.chunks_quarantined == 1
    finally:
        srv.close()
