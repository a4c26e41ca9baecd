"""Multi-rank engines (``repro_torch.core.engine_spmd``) on gloo ranks.

Each rank group runs in one spawn per rank count D ∈ {1, 2, 4}
(``torch.multiprocessing``, start method ``spawn``, a file-based
rendezvous under the test's temporary directory, a 60 s process-group
timeout and a join time limit), on the CPU, with ``num_workers = 8`` split
over the ranks.  Every rank runs the same drives:

* ``frozen`` — :class:`SPMDEngine` on 4,096 tuples, 8 columns, 16 uneven
  ASCII chunks, a synopsis cache of 32 rows;
* ``slot`` / ``slot-ref`` — :class:`SlotSPMDEngine` on 2,048 tuples, 12
  chunks, a mid-scan admission at round 3, the fused path's plain version
  and the ``ref`` composition;
* ``stream`` / ``stream-decoded`` — the slot drive streamed, without and
  with a two-chunk decoded cache;
* ``grouped`` / ``grouped-ref`` — 2,048 wiki-like tuples, 8 chunks,
  ``max_groups=4``;
* ``server`` — the workload server with ``max_slots=4`` and a synopsis
  (seeded mid-scan admissions), ``sched-neutral`` / ``sched-variance`` —
  scheduled, ``rollup`` — with the rollup tier;
* ``fault`` — the stream drive with a permanently lost chunk that a rank
  other than 0 reads (under D > 1).

Every rank's state after every round (``cur`` gathered, ``head``,
``stats``, ``scan_m``, ``cache``, estimates, the group cells and tallies),
and the server's results, must equal the single-device port's bit for bit.
The single-device port is held to the JAX single-device ``ref`` engine on
the same numpy inputs: integers equal, floats within a float32 relative
1e-5 (the same terms summed in another order).  A wall-clock cut must stop
every rank after the same round, and a worker count the ranks do not
divide is refused.  On the card (marked ``cuda``), the round kernels at a
rank's worker widths W ∈ {1, 2} against their plain versions and against
their own W = 4 rows.
"""

import dataclasses
import datetime
import os
import pickle
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import sched as tsched
from repro_torch.core import engine as t_eng
from repro_torch.core import queries as tq
from repro_torch.core.engine_spmd import SlotSPMDEngine, SPMDEngine
from repro_torch.data.faults import FaultConfig, FaultInjector
from repro_torch.data.generator import (make_synthetic_zipf, make_wiki_like,
                                        store_dataset as t_store)
from repro_torch.serve import ola_server as ts
from repro_torch.serve.rollup import RollupConfig as TRollupConfig

RANKS = (1, 2, 4)
WORKERS = 8
JOIN_S = 300.0                              # a rank group's time limit
PG_TIMEOUT = datetime.timedelta(seconds=60)
RTOL = 1e-5
COEF = tuple(1.0 / (k + 1) for k in range(8))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# The drives, over either package (P) and, for the port, a mesh or none
# ---------------------------------------------------------------------------

def _port(mesh=None):
    """The port's namespace: single-device engines, or the multi-rank ones
    over ``mesh``."""
    def slot_engine(store, s, cfg):
        if mesh is None:
            return t_eng.SlotOLAEngine(store, s, cfg, device="cpu")
        return SlotSPMDEngine(store, s, cfg, mesh, device="cpu")

    def frozen_engine(store, qs, cfg):
        if mesh is None:
            return t_eng.OLAEngine(store, qs, cfg, device="cpu")
        return SPMDEngine(store, qs, cfg, mesh, device="cpu")

    def server(store, cfg, **opts):
        return ts.OLAWorkloadServer(store, cfg, ts.ServerOptions(
            mesh=mesh, **opts), device="cpu")

    return SimpleNamespace(
        q=tq, Config=t_eng.EngineConfig, store=t_store, sched=tsched,
        Rollup=TRollupConfig, slot_engine=slot_engine,
        frozen_engine=frozen_engine, server=server,
        table=lambda s, c, g=0: tq.empty_slot_table(s, c, g, device="cpu"),
        gather=lambda eng, x: eng.coll.gather_workers(x), backend="cuda")


def _reference():
    """The JAX package's namespace (single device, ``ref`` EXTRACT)."""
    from repro import sched as jsched
    from repro.core import engine as j_eng
    from repro.core import queries as jq
    from repro.data.generator import store_dataset as j_store
    from repro.serve import ola_server as js
    from repro.serve.rollup import RollupConfig as JRollupConfig

    return SimpleNamespace(
        q=jq, Config=j_eng.EngineConfig, store=j_store, sched=jsched,
        Rollup=JRollupConfig,
        slot_engine=lambda store, s, cfg: j_eng.SlotOLAEngine(store, s, cfg),
        frozen_engine=lambda store, qs, cfg: j_eng.OLAEngine(store, qs, cfg),
        server=lambda store, cfg, **opts: js.OLAWorkloadServer(
            store, cfg, options=js.ServerOptions(**opts)),
        table=lambda s, c, g=0: jq.empty_slot_table(s, c, g),
        gather=lambda eng, x: x, backend="ref")


STATE_FIELDS = ("head", "scan_m", "offset", "closed", "acc_met",
                "raw_touched", "quarantined", "stopped", "round", "budget",
                "decay", "calib_sum", "calib_cnt", "t_io", "t_cpu", "cache",
                "schedule")
STATS_FIELDS = ("m", "ysum", "ysq", "psum")
GROUP_FIELDS = ("gm", "gys", "gyq", "gps")
REPORT_FIELDS = ("estimate", "lo", "hi", "err", "decided", "n_chunks",
                 "m_tuples", "bytes_round", "tuples_round", "all_stopped",
                 "exhausted")
GROUP_REPORT = ("g_est", "g_err", "g_n", "g_tal")


def _record(P, eng, state, rep=None, grouped=False) -> dict:
    out = {f: _np(getattr(state, f)) for f in STATE_FIELDS}
    out["cur"] = _np(P.gather(eng, state.cur))
    out.update({f: _np(getattr(state.stats, f)) for f in STATS_FIELDS})
    if grouped:
        out.update({f: _np(getattr(state, f)) for f in GROUP_FIELDS})
    if rep is not None:
        out.update({f: _np(getattr(rep, f)) for f in REPORT_FIELDS})
        if grouped:
            out.update({f: _np(getattr(rep, f)) for f in GROUP_REPORT})
    return out


def _zipf_store(P, n=2048, chunks=12):
    return P.store(make_synthetic_zipf(n, 8, seed=3), chunks, "ascii",
                   uneven=True)


def _slot_queries(q):
    return [q.Query(agg="sum", expr=q.Linear(COEF), pred=q.Range(0, 0.0, 6e7),
                    epsilon=0.04, name="s"),
            q.Query(agg="count", pred=q.Range(1, 0.0, 7e7), epsilon=0.06,
                    name="c"),
            q.Query(agg="avg", expr=q.Linear(COEF), epsilon=0.05, name="a")]


def _slot_cfg(P, **kw):
    # a fixed t_eval: one round step per engine
    return P.Config(num_workers=WORKERS, budget_init=32, budget_min=32,
                    budget_max=32, seed=5, cache_cap=16,
                    extract_backend=kw.pop("extract_backend", P.backend),
                    **kw)


def _slot_drive(P, store, cfg, rounds=24):
    """test_engine_spmd.py's slot drive: two slots, a third admitted at
    round 3, a fixed budget; the state after every round."""
    eng = P.slot_engine(store, 4, cfg)
    q0, q1, q2 = _slot_queries(P.q)
    q = P.q
    table = P.table(4, 8)
    table = q.slot_table_set(table, 0, q.encode_slot(q0, 8,
                                                     plan="single_pass"))
    table = q.slot_table_set(table, 1, q.encode_slot(q1, 8,
                                                     plan="single_pass"))
    try:
        state = eng.init_state()
        trace = []
        for r in range(rounds):
            if r == 3:
                table = q.slot_table_set(table, 2, q.encode_slot(
                    q2, 8, plan="single_pass"))
            b = eng.budget_ladder(float(state.budget))
            state, data = eng.round_data(state)
            mode, data = eng.data_mode(data)
            state, rep = eng.round_fn(b, mode)(state, table, data,
                                               eng.speeds)
            rec = _record(P, eng, state, rep)
            rec["mode"] = np.asarray(mode)
            trace.append(rec)
        return dict(trace=trace, quarantine_log=list(
            getattr(eng, "quarantine_log", [])))
    finally:
        eng.close()


def _block_bytes(store):
    return int(store.max_chunk_tuples) * store.codec.num_cols * 4


def _lost_chunk(store) -> int:
    """A chunk worker 5 claims first: under 2 and 4 ranks a rank other
    than 0 reads it."""
    from repro_torch.sampling.permutation import random_chunk_order

    return int(random_chunk_order(5, store.num_chunks)[5])


def drive_slot(P):
    return _slot_drive(P, _zipf_store(P), _slot_cfg(P))


def drive_slot_ref(P):
    return _slot_drive(P, _zipf_store(P), _slot_cfg(P, extract_backend="ref"))


def drive_stream(P):
    return _slot_drive(P, _zipf_store(P), _slot_cfg(P, residency="stream"))


def drive_stream_decoded(P):
    store = _zipf_store(P)
    return _slot_drive(P, store, _slot_cfg(
        P, residency="stream", decoded_cache_bytes=2 * _block_bytes(store)))


def drive_fault(P):
    store = _zipf_store(P)
    lost = _lost_chunk(store)
    return _slot_drive(P, FaultInjector(store, FaultConfig(
        lost_chunks=(lost,))), _slot_cfg(P, residency="stream"))


def drive_frozen(P, rounds=300):
    """test_engine_spmd.py's frozen drive: 4,096 tuples, 16 uneven chunks,
    single-pass, a synopsis cache of 32 rows."""
    store = _zipf_store(P, 4096, 16)
    q = P.q
    query = q.Query(agg="sum", expr=q.Linear(COEF),
                    pred=q.Range(0, 0.0, 0.5e8), epsilon=0.05)
    cfg = P.Config(num_workers=WORKERS, strategy="single_pass",
                   budget_init=64, seed=5, cache_cap=32,
                   extract_backend=P.backend)
    eng = P.frozen_engine(store, [query], cfg)
    state = eng.init_state()
    trace = []
    for _ in range(rounds):
        b = eng.budget_ladder(float(state.budget))
        state, data = eng.round_data(state)
        mode, data = eng.data_mode(data)
        state, rep = eng.round_fn(b, mode)(state, data, eng.speeds)
        trace.append(_record(P, eng, state, rep))
        if bool(rep.all_stopped) or bool(rep.exhausted):
            break
    return dict(trace=trace)


def _grouped_drive(P, backend, rounds=10):
    wv, _ = make_wiki_like(2048, num_languages=12, seed=7)
    store = P.store(wv, 8, "ascii", uneven=True)
    cfg = P.Config(num_workers=WORKERS, budget_init=32, budget_min=32,
                   budget_max=32, seed=5, cache_cap=16, max_groups=4,
                   extract_backend=backend)
    q = P.q
    qg = q.Query(agg="sum", expr=q.Linear((0.0, 1.0, 0.0, 0.0)),
                 epsilon=0.03, group_by=q.GroupBy(col=0, max_groups=4,
                                                  top_k=2,
                                                  values=[0.0, 1.0, 2.0]))
    qd = q.Query(agg="count", pred=q.Range(3, 0.0, 400.5), epsilon=0.05,
                 group_by=q.GroupBy(col=0, max_groups=4, top_k=2))
    eng = P.slot_engine(store, 2, cfg)
    table = P.table(2, 4, 4)
    table = q.slot_table_set(table, 0, q.encode_slot(
        qg, 4, plan="single_pass", max_groups=4))
    table = q.slot_table_set(table, 1, q.encode_slot(
        qd, 4, plan="single_pass", max_groups=4))
    state = eng.init_state()
    trace = []
    for _ in range(rounds):
        b = eng.budget_ladder(float(state.budget))
        state, data = eng.round_data(state)
        state, rep = eng.round_fn(b)(state, table, data, eng.speeds)
        trace.append(_record(P, eng, state, rep, grouped=True))
    return dict(trace=trace)


def drive_grouped(P):
    return _grouped_drive(P, P.backend)


def drive_grouped_ref(P):
    return _grouped_drive(P, "ref")


RESULT_FIELDS = ("qid", "name", "plan", "sched_outcome", "slo_met",
                 "rounds_resident", "tuples_seen", "seeded_tuples",
                 "decision", "from_synopsis", "unserved", "estimate", "lo",
                 "hi", "err", "t_admit", "t_done", "queue_wait")
RESULT_INTS = RESULT_FIELDS[:11]


def _serve(P, phases, rounds_cap=4000, **opts):
    """Serve ``phases`` (lists of ``(query, arrival_t, slo)``, each
    submitted once the previous one has run out) on 2,048 tuples in 12
    chunks: the state after every round and the results."""
    store = _zipf_store(P)
    cfg = P.Config(num_workers=WORKERS, seed=5, extract_backend=P.backend)
    srv = P.server(store, cfg, **opts)
    trace = []

    def on_round(s):
        trace.append(_record(P, s.engine, s.state))

    try:
        for phase in phases(P):
            for query, at, slo in phase:
                srv.submit(query, arrival_t=at, slo=slo)
            srv.run(max_rounds=rounds_cap, on_round=on_round)
        res = [tuple(getattr(r, f) for f in RESULT_FIELDS)
               for r in sorted(srv.results, key=lambda r: r.qid)]
        return dict(trace=trace, results=res, rounds=srv.rounds)
    finally:
        srv.close()


def _server_phases(P):
    q0, q1, q2 = _slot_queries(P.q)
    return [[(q0, 0.0, None), (q1, 0.0, None), (q2, 2e-4, None)]]


def _sched_phases(P):
    q0, q1, q2 = _slot_queries(P.q)
    slo = P.sched.QuerySLO
    return [[(q0, 0.0, slo(priority="batch")),
             (q1, 0.0, slo(priority="interactive")),
             (q2, 1e-4, slo(priority="interactive", deadline_s=5e-3))]]


def _rollup_phases(P):
    q = P.q

    def hot(name):
        return q.Query(agg="sum", expr=q.Linear(COEF),
                       pred=q.Range(0, 0.0, 6e7), epsilon=0.08, name=name)

    return [[(hot("r0"), 0.0, None), (hot("r1"), 0.0, None)],
            [(hot("r2"), None, None)]]


def drive_server(P):
    return _serve(P, _server_phases, max_slots=4, synopsis_budget_tuples=512)


def drive_sched_neutral(P):
    return _serve(P, _sched_phases, max_slots=2, synopsis_budget_tuples=512,
                  scheduler=P.sched.WorkloadScheduler(P.sched.NEUTRAL))


def drive_sched_variance(P):
    return _serve(P, _sched_phases, max_slots=2, synopsis_budget_tuples=512,
                  scheduler=P.sched.WorkloadScheduler(P.sched.SchedulerConfig(
                      slot_capacity=1.0, preempt=True,
                      claim_policy="variance")))


def drive_rollup(P):
    return _serve(P, _rollup_phases, max_slots=4, synopsis_budget_tuples=512,
                  rollup=P.Rollup(promote_hits=2))


DRIVES = {
    "frozen": drive_frozen, "slot": drive_slot, "slot-ref": drive_slot_ref,
    "stream": drive_stream, "stream-decoded": drive_stream_decoded,
    "grouped": drive_grouped, "grouped-ref": drive_grouped_ref,
    "server": drive_server, "sched-neutral": drive_sched_neutral,
    "sched-variance": drive_sched_variance, "rollup": drive_rollup,
    "fault": drive_fault,
}
# the drives the JAX reference runs too (the fault injector's store is
# the port's own)
REFERENCE_DRIVES = tuple(d for d in DRIVES if d != "fault")


def _wall_cut(P, rank):
    """A server run whose wall-clock limit cuts it: every rank sleeps
    after every round, the later ranks longer, so their clocks run apart;
    the cut must still land after the same round on every rank."""
    store = _zipf_store(P)
    srv = P.server(store, P.Config(num_workers=WORKERS, seed=5,
                                   extract_backend=P.backend),
                   max_slots=4, synopsis_budget_tuples=0)
    q0, q1, _ = _slot_queries(P.q)
    srv.submit(dataclasses.replace(q0, epsilon=1e-6), arrival_t=0.0)
    srv.submit(dataclasses.replace(q1, epsilon=1e-6), arrival_t=0.0)

    def on_round(s):
        time.sleep(0.02 * (rank + 1))

    try:
        srv.run(wall_timeout_s=0.1, on_round=on_round)
        return dict(rounds=srv.rounds, truncated=srv.truncated)
    finally:
        srv.close()


def _engine_wall_cut(P, rank):
    """SPMDEngine.run with a wall-clock limit shorter than the scan."""
    store = _zipf_store(P, 4096, 16)
    q = P.q
    query = q.Query(agg="sum", expr=q.Linear(COEF), epsilon=1e-6)
    cfg = P.Config(num_workers=WORKERS, strategy="chunk_level",
                   budget_init=8, budget_min=8, budget_max=8, seed=5,
                   extract_backend=P.backend)
    eng = P.frozen_engine(store, [query], cfg)
    real = eng.round_fn

    def slow(b, mode="none"):
        step = real(b, mode)

        def run(*a):
            time.sleep(0.01 * (rank + 1))
            return step(*a)
        return run

    eng.round_fn = slow
    _, hist = eng.run(wall_timeout_s=0.1)
    return dict(rounds=len(hist), exhausted=bool(hist[-1].exhausted))


def _rank_main(rank, ranks, pg_file, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_file}",
                            rank=rank, world_size=ranks, timeout=PG_TIMEOUT)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (ranks,), mesh_dim_names=("data",))
        P = _port(mesh)
        out = {name: fn(P) for name, fn in DRIVES.items()}
        out["wall-cut"] = _wall_cut(P, rank)
        out["engine-wall-cut"] = _engine_wall_cut(P, rank)
        try:
            SlotSPMDEngine(_zipf_store(P), 4, t_eng.EngineConfig(
                num_workers=ranks + 1), mesh, device="cpu")
            out["refused"] = None
        except AssertionError as e:
            out["refused"] = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(ranks: int, tmp) -> list[dict]:
    ctx = mp.start_processes(_rank_main,
                             args=(ranks, str(tmp / "pg"), str(tmp)),
                             nprocs=ranks, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{ranks} ranks did not finish within {JOIN_S} s")
    out = []
    for r in range(ranks):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def single():
    P = _port()
    return {name: fn(P) for name, fn in DRIVES.items()}


@pytest.fixture(scope="module", params=RANKS, ids=lambda d: f"D{d}")
def ranked(request, tmp_path_factory):
    d = request.param
    return d, _spawn(d, tmp_path_factory.mktemp(f"spmd{d}"))


@pytest.fixture(scope="module")
def reference():
    P = _reference()
    return {name: DRIVES[name](P) for name in REFERENCE_DRIVES}


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def _assert_trace_bits(got: list, want: list, where: str):
    assert len(got) == len(want), f"{where}: {len(got)} != {len(want)} rounds"
    for r, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert _same_bits(g[k], w[k]), f"{where}, round {r}: {k}"


def _results_bits(got, want, where):
    assert len(got) == len(want), where
    for g, w in zip(got, want):
        for f, u, v in zip(RESULT_FIELDS, g, w):
            assert u == v or (u != u and v != v), f"{where}: {w[1]} {f}"


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_ranks_match_single_device_bitwise(ranked, single, drive):
    """Every rank's state after every round equals the single-device
    port's, bit for bit (so every rank agrees with rank 0)."""
    d, outs = ranked
    want = single[drive]
    for rank, out in enumerate(outs):
        got = out[drive]
        # the decoded round variant is the rank's own choice (its workers'
        # decoded hits); every variant gives the same state
        modes = {str(r.pop("mode")) for r in got["trace"] if "mode" in r}
        _assert_trace_bits(got["trace"], [
            {k: v for k, v in r.items() if k != "mode"}
            for r in want["trace"]], f"D={d} rank {rank} {drive}")
        if drive == "stream-decoded":
            assert modes & {"mixed", "all"}, modes
        if "results" in want:
            assert got["rounds"] == want["rounds"]
            _results_bits(got["results"], want["results"],
                          f"D={d} rank {rank} {drive}")
        if "quarantine_log" in want:
            assert got["quarantine_log"] == want["quarantine_log"]


def test_drives_exercise_their_paths(single):
    """The drives reach what they are for: admissions and retirements,
    mixed decoded rounds, a quarantine in the round the lost chunk is
    first claimed, tier-1 answers, promoted group cells, a cache filled."""
    modes = {str(r["mode"]) for r in single["stream-decoded"]["trace"]}
    assert "mixed" in modes, modes
    fault = single["fault"]
    lost = fault["quarantine_log"]
    assert len(lost) == 1 and fault["trace"][0]["quarantined"][lost[0]]
    assert any(r[3] == "tier1" for r in single["rollup"]["results"])
    assert any(r[9] for r in single["server"]["results"]) or any(
        r[7] > 0 for r in single["server"]["results"])
    for name in ("slot", "frozen", "server"):
        assert single[name]["trace"][-1]["cache"].any(), name
    assert single["grouped"]["trace"][-1]["g_tal"].any()
    assert (single["grouped"]["trace"][-1]["gm"] > 0).any()


@pytest.mark.parametrize("drive", sorted(REFERENCE_DRIVES))
def test_single_device_matches_reference(single, reference, drive):
    """The single-device port against the JAX single-device ``ref``
    engine on the same inputs: integer state and report fields equal,
    floats within a float32 relative 1e-5."""
    got, want = single[drive], reference[drive]
    assert len(got["trace"]) == len(want["trace"]), drive
    for r, (g, w) in enumerate(zip(got["trace"], want["trace"])):
        for k, wv in w.items():
            gv = g[k]
            if k == "mode":
                assert str(gv) == str(wv), (drive, r)
            elif np.asarray(wv).dtype.kind == "f":
                np.testing.assert_allclose(
                    gv, wv, rtol=RTOL, atol=0,
                    err_msg=f"{drive}, round {r}: {k}")
            else:
                assert np.array_equal(gv, wv), f"{drive}, round {r}: {k}"
    if "results" in want:
        assert got["rounds"] == want["rounds"]
        for g, w in zip(got["results"], want["results"]):
            for f, u, v in zip(RESULT_FIELDS, g, w):
                if f in RESULT_INTS:
                    assert u == v, (drive, w[1], f)
                else:
                    np.testing.assert_allclose(u, v, rtol=RTOL,
                                               err_msg=f"{drive} {w[1]} {f}")


def test_wall_clock_cut_is_agreed(ranked):
    """Ranks whose clocks run apart stop after the same round."""
    d, outs = ranked
    cuts = {(o["wall-cut"]["rounds"], o["wall-cut"]["truncated"])
            for o in outs}
    assert len(cuts) == 1, cuts
    ((rounds, truncated),) = cuts
    assert truncated and rounds > 0
    assert len({o["engine-wall-cut"]["rounds"] for o in outs}) == 1
    assert not outs[0]["engine-wall-cut"]["exhausted"]


def test_indivisible_worker_count_is_refused(ranked):
    """D + 1 workers do not divide over D > 1 ranks (the reference's
    message); over one rank they do."""
    d, outs = ranked
    want = (None if d == 1 else f"num_workers={d + 1} must divide over "
            f"data axis size {d}")
    assert [o["refused"] for o in outs] == [want] * d


# ---------------------------------------------------------------------------
# On the card: the round kernels at the ranks' worker widths
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every test worker collects
    # the same tests whether or not it sees a card
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def _width_case(b: int, device, grouped: bool):
    """One round's inputs for W = 4 workers (one idle) on a 6-chunk packed
    store of 16 ASCII columns (column 0 an integer group value when
    ``grouped``): the packed store, the slab of the workers' chunks, the
    window, budgets, a non-negative 4-slot plan, scan positions, and the
    group descriptors."""
    from repro_torch.data.formats import AsciiFixedFormat
    from repro_torch.sampling.permutation import (chunk_seed,
                                                  permutation_window_dyn)

    rng = np.random.default_rng(b)
    n, m, c, s = 6, max(4096, b), 16, 4
    vals = make_synthetic_zipf(n * m, c, seed=b)
    if grouped:
        vals[:, 0] = rng.integers(0, 6, n * m)
    packed = AsciiFixedFormat(c).encode(vals).reshape(n, m, -1)
    jw = rng.choice(n, size=4, replace=False)
    idx = permutation_window_dyn(
        chunk_seed(7, torch.as_tensor(jw)), torch.as_tensor(
            rng.integers(0, m, 4)), b, torch.full((4,), m), m)
    coeffs = np.abs(rng.normal(size=(s, c))).astype(np.float32)
    lo = np.full((s, c), -np.inf, np.float32)
    hi = np.full((s, c), np.inf, np.float32)
    hi[1, 2] = 4.00005e7
    plan = [torch.as_tensor(a, device=device) for a in (
        coeffs, lo, hi, np.asarray([0, 1, 0, 0], np.float32),
        np.asarray([1, 1, 0, 1], np.float32),
        np.asarray([1, 0.5, 1, 0.77], np.float32))]
    g = 5
    gval = np.zeros((s, g), np.float32)
    gact = np.zeros((s, g), np.float32)
    gval[0, :3], gact[0, :3], gact[0, -1], gact[2, -1] = (0, 1, 2), 1, 1, 1
    groups = [torch.as_tensor(a, device=device) for a in (
        np.asarray([0, -1, 0, -1], np.int32), gval, gact)]
    packed_t = torch.as_tensor(packed, device=device)
    jw_t = torch.as_tensor(jw.astype(np.int32), device=device)
    return dict(
        packed=packed_t, slab=packed_t[jw_t.long()].contiguous(), jw=jw_t,
        idx=idx.to(torch.int32).to(device),
        b_eff=torch.as_tensor(np.asarray([b, max(b - 3, 1), b // 2, 0],
                                         np.int32), device=device),
        m_before=torch.as_tensor(np.asarray([0, 5, 100, 127], np.int32),
                                 device=device),
        plan=plan, groups=groups,
        salt=torch.tensor([3], dtype=torch.int32, device=device))


def _width_call(kernel: str, case: dict, sel: slice):
    """``kernel`` through its ``ops`` entry point on workers ``sel`` of
    ``case``: the kernel for CUDA tensors, its plain version for CPU
    ones."""
    from repro_torch.kernels import ops

    w = {k: case[k][sel] for k in ("jw", "idx", "b_eff", "m_before",
                                   "slab")}
    if kernel == "slot_extract":
        return ops.slot_extract(case["packed"], w["jw"], w["idx"],
                                w["b_eff"], *case["plan"][:5],
                                weights=case["plan"][5], return_cols=True)
    if kernel == "slot_extract_grouped":
        gcol, gval, gact = case["groups"]
        return ops.slot_extract(case["packed"], w["jw"], w["idx"],
                                w["b_eff"], *case["plan"][:5],
                                weights=case["plan"][5], return_cols=True,
                                gcol=gcol, gval=gval, gact=gact,
                                salt=case["salt"])
    src = w["slab"]
    if kernel == "slot_eval_decoded":
        rec = src.shape[2]
        src = ops.extract_parse(src.reshape(-1, rec), rec // 16).reshape(
            src.shape[0], src.shape[1], rec // 16)
        fn = ops.slot_eval_decoded
    else:
        fn = ops.slot_extract_stream
    return fn(src, w["idx"], w["b_eff"], *case["plan"][:5],
              weights=case["plan"][5], cache_cap=128,
              m_before=w["m_before"])


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("kernel", ["slot_extract", "slot_extract_stream",
                                    "slot_eval_decoded",
                                    "slot_extract_grouped"])
def test_kernels_at_rank_widths_on_the_card(cuda_device, kernel, w):
    """At W = 1 and 2 workers (a rank's share of 2 or 4) each round kernel
    matches its plain version (m lane equal, sums within (2B+16)·2^-24
    relative; see chip_smoke.py), three launches give the same bits, and
    every worker's outputs equal its rows of the W = 4 launch bit for bit:
    the launch grid is (tiles(B), W), so a worker's blocks and fold order
    do not depend on W."""
    grouped = kernel == "slot_extract_grouped"
    for b in (1, 33, 257, 4096):
        case = _width_case(b, cuda_device, grouped)
        cpu = {k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
               for k, v in case.items()}
        full = _width_call(kernel, case, slice(0, 4))
        for lo_w in range(0, 4, w):
            sel = slice(lo_w, lo_w + w)
            runs = [_width_call(kernel, case, sel) for _ in range(3)]
            plain = _width_call(kernel, cpu, sel)
            torch.cuda.synchronize()
            for got, again, first in zip(runs[0], runs[1], full):
                assert torch.equal(got.view(torch.int32),
                                   again.view(torch.int32)), (kernel, b)
                assert torch.equal(got.view(torch.int32),
                                   first[sel].view(torch.int32)), (kernel, b)
            stats, want = runs[0][0].cpu().numpy(), plain[0].numpy()
            assert np.array_equal(stats[..., 0], want[..., 0])
            np.testing.assert_allclose(stats[..., 1:], want[..., 1:],
                                       rtol=(2 * b + 16) * 2.0 ** -24,
                                       atol=0)
