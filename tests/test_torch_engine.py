"""Port parity: engine rounds against the JAX package's ``ref`` path.

``SlotOLAEngine`` runs round for round beside the reference's
(``extract_backend="ref"``) on the same store and slot table, under both of
the port's EXTRACT backends on the CPU: ``"ref"`` (decode + slot evaluator,
bit-identical to the reference up to the order of the per-round sums) and
``"cuda"`` (the fused kernel's plain version for CPU tensors).  Integer
state must be identical every round.  The float statistics are float32 sums
of the same terms in another order, accumulated over the rounds: they agree
to a relative 1e-5.  The frozen plane (``OLAEngine``, the
``EstimationController``) runs the quickstart workload the same way.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import controller as j_ctl
from repro.core import engine as j_eng
from repro.core import queries as jq
from repro.data.generator import make_synthetic_zipf, store_dataset as j_store
from repro_torch.core import controller as t_ctl
from repro_torch.core import engine as t_eng
from repro_torch.core import queries as tq
from repro_torch.data.generator import store_dataset as t_store

INT_FIELDS = ("scan_m", "offset", "closed", "acc_met", "head", "cur",
              "raw_touched", "stopped", "round", "cpu_bound", "first_est")
FLOAT_FIELDS = ("budget", "decay", "calib_sum", "calib_cnt", "t_io", "t_cpu")
RTOL = 1e-5


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_states(ts, js, where):
    for f in INT_FIELDS:
        assert np.array_equal(_np(getattr(ts, f)), _np(getattr(js, f))), (
            f"{where}: {f}")
    assert np.array_equal(_np(ts.stats.m), _np(js.stats.m)), f"{where}: m"
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(_np(getattr(ts, f)), _np(getattr(js, f)),
                                   rtol=RTOL, err_msg=f"{where}: {f}")
    for f in ("ysum", "ysq", "psum"):
        np.testing.assert_allclose(_np(getattr(ts.stats, f)),
                                   _np(getattr(js.stats, f)), rtol=RTOL,
                                   atol=1e-3, err_msg=f"{where}: {f}")
    np.testing.assert_allclose(_np(ts.cache), _np(js.cache), rtol=0, atol=0)


def _slot_queries(mod, c):
    coef = tuple(1.0 / (k + 1) for k in range(c))
    return [
        mod.Query(agg="sum", expr=mod.Linear(coef),
                  pred=mod.Range(0, 0.0, 6e7), epsilon=0.04, name="s"),
        mod.Query(agg="count", pred=mod.Range(0, 0.0, 4e7), epsilon=0.08,
                  name="c"),
        mod.Query(agg="avg", expr=mod.Linear(coef), epsilon=0.05, name="a"),
        mod.Query(agg="sum", expr=mod.Column(1),
                  having=mod.Having(">", 1e9), epsilon=0.02, name="h"),
    ]


@pytest.fixture(scope="module")
def store8():
    vals = make_synthetic_zipf(4096, 8, seed=3)
    return j_store(vals, 24, "ascii", uneven=True, seed=3), \
        t_store(vals, 24, "ascii", uneven=True, seed=3)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_slot_engine_round_for_round(store8, backend):
    plans = ("single_pass", "chunk_level", "holistic", "resource_aware")
    js, ts = store8
    jcfg = j_eng.EngineConfig(num_workers=3, seed=5, cache_cap=64)
    tcfg = t_eng.EngineConfig(num_workers=3, seed=5, cache_cap=64,
                              extract_backend=backend)
    je = j_eng.SlotOLAEngine(js, max_slots=5, config=jcfg)
    te = t_eng.SlotOLAEngine(ts, max_slots=5, config=tcfg, device="cpu")
    jt = jq.empty_slot_table(5, 8)
    tt = tq.empty_slot_table(5, 8, device="cpu")
    pairs = list(zip(_slot_queries(jq, 8), _slot_queries(tq, 8)))
    jst, tst = je.init_state(), te.init_state()
    admit_at = {0: [0, 1], 3: [2], 6: [3]}       # mid-scan admissions
    retire_at = {9: 1}
    for r in range(30):
        for s in admit_at.get(r, []):
            jrow = jq.encode_slot(pairs[s][0], 8, plan=plans[s])
            trow = tq.encode_slot(pairs[s][1], 8, plan=plans[s])
            jt = jq.slot_table_set(jt, s, jrow)
            tt = tq.slot_table_set(tt, s, trow)
        if r in retire_at:
            jt = jq.slot_table_clear(jt, retire_at[r])
            tt = tq.slot_table_clear(tt, retire_at[r])
        jb = je.budget_ladder(float(jst.budget))
        tb = te.budget_ladder(float(tst.budget))
        assert jb == tb, f"round {r}: budget rung"
        jst, jrep = je.round_fn(jb)(jst, jt, je.packed, je.speeds)
        tst, trep = te.round_fn(tb)(tst, tt, te.packed, te.speeds)
        _assert_states(tst, jst, f"round {r}")
        assert np.array_equal(_np(trep.decided), _np(jrep.decided))
        assert bool(trep.exhausted) == bool(jrep.exhausted)
        live = _np(tt.active)
        np.testing.assert_allclose(_np(trep.estimate)[live],
                                   _np(jrep.estimate)[live], rtol=RTOL)
        if bool(jrep.exhausted):
            break


def test_worker_speeds_and_plan_claims(store8):
    js, ts = store8
    speeds = (1.0, 0.5, 0.25)
    je = j_eng.SlotOLAEngine(js, 2, j_eng.EngineConfig(
        num_workers=3, seed=1, worker_speed=speeds))
    te = t_eng.SlotOLAEngine(ts, 2, t_eng.EngineConfig(
        num_workers=3, seed=1, worker_speed=speeds), device="cpu")
    jt = jq.slot_table_set(jq.empty_slot_table(2, 8), 0, jq.encode_slot(
        _slot_queries(jq, 8)[0], 8))
    tt = tq.slot_table_set(tq.empty_slot_table(2, 8, device="cpu"), 0,
                           tq.encode_slot(_slot_queries(tq, 8)[0], 8))
    jst, tst = je.init_state(), te.init_state()
    for r in range(6):
        for a, b in zip(te.program.plan_claims(tst),
                        je.program.plan_claims(jst)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        jst, _ = je.round_fn(64)(jst, jt, je.packed, je.speeds)
        tst, _ = te.round_fn(64)(tst, tt, te.packed, te.speeds)
        _assert_states(tst, jst, f"round {r}")


@pytest.mark.parametrize("kw", [
    dict(residency="stream"), dict(decoded_cache_bytes=1),
    dict(max_groups=2), dict(extract_backend="pallas")],
    ids=["stream", "decoded", "groups", "pallas"])
def test_unported_options_raise(kw):
    """The Pallas backends stay unported; streaming residency, its decoded
    cache and GROUP BY capacity build; the cache without streaming and a
    negative group capacity are refused."""
    if "max_groups" in kw:
        assert t_eng.EngineConfig(**kw).max_groups == 2
        with pytest.raises(ValueError):
            t_eng.EngineConfig(max_groups=-1)
    elif kw.get("residency") == "stream":
        cfg = t_eng.EngineConfig(decoded_cache_bytes=1 << 20, **kw)
        assert (cfg.residency, cfg.slab_row_tile, cfg.prefetch_lookahead,
                cfg.prefetch_adaptive) == ("stream", 256, 8, False)
        with pytest.raises(ValueError):
            t_eng.EngineConfig(residency="mmap")
    elif "decoded_cache_bytes" in kw:
        with pytest.raises(ValueError, match="residency='stream'"):
            t_eng.EngineConfig(**kw)
        with pytest.raises(ValueError):
            t_eng.EngineConfig(residency="stream", decoded_cache_bytes=-1)
    else:
        with pytest.raises(NotImplementedError):
            t_eng.EngineConfig(**kw)


def _auto_programs(store, device):
    """``extract_backend="auto"`` resolved for an ASCII slot engine, an
    ASCII frozen engine with a linear query and with a non-linear one, a
    float64 slot engine and a binary-codec slot engine."""
    auto = dict(extract_backend="auto")
    lin = tq.Query(agg="sum", expr=tq.Linear((1.0,) * 8))
    sq = tq.Query(agg="sum", expr=tq.SquaredDiff(0, 1))
    binary = t_store(make_synthetic_zipf(512, 8, seed=1), 4, "binary")
    return [
        t_eng.SlotOLAEngine(store, 2, t_eng.EngineConfig(**auto),
                            device=device).program,
        t_eng.OLAEngine(store, [lin], t_eng.EngineConfig(**auto),
                        device=device).program,
        t_eng.OLAEngine(store, [sq], t_eng.EngineConfig(**auto),
                        device=device).program,
        t_eng.SlotOLAEngine(store, 2, t_eng.EngineConfig(
            stats_dtype="float64", **auto), device=device).program,
        t_eng.SlotOLAEngine(binary, 2, t_eng.EngineConfig(**auto),
                            device=device).program]


def test_auto_backend_resolves_to_ref_on_the_cpu(store8):
    """``"auto"`` picks the fused kernel only on a CUDA device: every CPU
    engine resolves to the ``ref`` composition (as the reference's
    ``"auto"`` does off the TPU)."""
    _, ts = store8
    for prog in _auto_programs(ts, "cpu"):
        assert (prog.extract_backend, prog.fused) == ("ref", False)
    assert t_eng.EngineConfig(extract_backend="auto").extract_backend == \
        "auto"


@pytest.mark.cuda
def test_auto_backend_resolves_on_the_card(store8):
    """On the card ``"auto"`` is ``"cuda"`` for ASCII float32 engines whose
    queries lower to a linear plan, else ``"ref"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    _, ts = store8
    got = [p.extract_backend for p in _auto_programs(ts, "cuda")]
    assert got == ["cuda", "cuda", "ref", "ref", "ref"]


@pytest.fixture(scope="module")
def quickstart():
    """examples/quickstart.py's workload: 32,768 tuples x 16 columns in 64
    ASCII chunks, one SUM query with a range predicate, 4 workers, seed 7."""
    vals = make_synthetic_zipf(num_tuples=32768, num_cols=16, seed=0)
    coef = tuple(1.0 / (k + 1) for k in range(16))
    qs = [mod.Query(agg="sum", expr=mod.Linear(coef),
                    pred=mod.Range(0, 0.0, 5e7), epsilon=0.03)
          for mod in (jq, tq)]
    return (j_store(vals, 64, "ascii"), t_store(vals, 64, "ascii"), qs)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_frozen_engine_quickstart_round_for_round(quickstart, backend):
    js, ts, (jqq, tqq) = quickstart
    kw = dict(num_workers=4, strategy="resource_aware", seed=7)
    je = j_eng.OLAEngine(js, [jqq], j_eng.EngineConfig(**kw))
    te = t_eng.OLAEngine(ts, [tqq], t_eng.EngineConfig(
        extract_backend=backend, **kw), device="cpu")
    jst, jhist = je.run(max_rounds=400)
    tst, thist = te.run(max_rounds=400)
    assert len(thist) == len(jhist)
    for r, (a, b) in enumerate(zip(thist, jhist)):
        for f in ("n_chunks", "m_tuples", "decided", "all_stopped",
                  "exhausted", "tuples_round"):
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f))), f"{r}: {f}"
        for f in ("estimate", "round_cpu_s", "round_io_s", "bytes_round"):
            np.testing.assert_allclose(np.asarray(getattr(a, f)),
                                       np.asarray(getattr(b, f)), rtol=RTOL,
                                       err_msg=f"{r}: {f}")
    _assert_states(tst, jst, "final")


def test_controller_quickstart(quickstart):
    js, ts, (jqq, tqq) = quickstart
    kw = dict(num_workers=4, strategy="resource_aware", seed=7)
    jr = j_ctl.EstimationController(js, j_eng.EngineConfig(**kw),
                                    delta_model_s=0.002).run_query([jqq])
    tr = t_ctl.EstimationController(ts, t_eng.EngineConfig(**kw),
                                    delta_model_s=0.002,
                                    device="cpu").run_query([tqq])
    assert (tr.rounds, len(tr.reports)) == (jr.rounds, len(jr.reports))
    assert tr.tuples_ratio == jr.tuples_ratio
    assert tr.chunks_ratio == jr.chunks_ratio
    np.testing.assert_allclose(tr.final_estimate, jr.final_estimate,
                               rtol=RTOL)
    np.testing.assert_allclose([r.t_model for r in tr.reports],
                               [r.t_model for r in jr.reports], rtol=RTOL)


def test_entry_points_default_to_cuda_and_raise_without_it(quickstart):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ts, (_, tqq) = quickstart
    cfg = t_eng.EngineConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_eng.OLAEngine(ts, [tqq], cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_eng.SlotOLAEngine(ts, 2, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ctl.EstimationController(ts, cfg)
    assert jax.default_backend() == "cpu"


def test_slot_stats_snapshot_fold_write_match(store8):
    js, ts = store8
    je = j_eng.SlotOLAEngine(js, 3, j_eng.EngineConfig(num_workers=2, seed=2))
    te = t_eng.SlotOLAEngine(ts, 3, t_eng.EngineConfig(num_workers=2, seed=2),
                             device="cpu")
    jt, tt = jq.empty_slot_table(3, 8), tq.empty_slot_table(3, 8,
                                                            device="cpu")
    for s, (a, b) in enumerate(zip(_slot_queries(jq, 8)[:3],
                                   _slot_queries(tq, 8)[:3])):
        jt = jq.slot_table_set(jt, s, jq.encode_slot(a, 8))
        tt = tq.slot_table_set(tt, s, tq.encode_slot(b, 8))
    jst, tst = je.init_state(), te.init_state()
    for _ in range(5):
        jst, _ = je.round_fn(32)(jst, jt, je.packed, je.speeds)
        tst, _ = te.round_fn(32)(tst, tt, te.packed, te.speeds)
    want = j_eng.slot_stats_fold(jst, [0, 2])
    got = t_eng.slot_stats_fold(tst, [0, 2])
    assert t_eng.slot_stats_fold(tst, []) == {}
    for s in (0, 2):
        snap = t_eng.slot_stats_snapshot(tst, s)
        for k in ("m", "ysum", "ysq", "psum"):
            assert np.array_equal(snap[k], got[s][k])
            np.testing.assert_allclose(got[s][k], want[s][k], rtol=RTOL)
    # write slot 2's row into slot 1, and a zero row into slot 0
    stats, seeded = t_eng.slot_stats_write(tst.stats, 1, got[2], ts.num_chunks)
    jstats, jseeded = j_eng.slot_stats_write(jst.stats, 1, want[2],
                                             js.num_chunks)
    assert seeded == jseeded == int(got[2]["m"].sum())
    np.testing.assert_allclose(_np(stats.ysum), _np(jstats.ysum), rtol=RTOL)
    assert np.array_equal(_np(stats.m), _np(jstats.m))
    stats, seeded = t_eng.slot_stats_write(stats, 0, None, ts.num_chunks)
    assert seeded == 0 and not _np(stats.m)[0].any()
    assert np.array_equal(_np(tst.stats.m)[0], want[0]["m"])   # copy-on-write
