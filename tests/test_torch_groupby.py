"""Port parity: the online GROUP BY plane against the JAX package on the CPU.

* Data and host-side discovery: ``make_wiki_like`` arrays equal;
  ``pure_buckets``, ``GroupSketch`` and ``promote_values`` give the same
  outputs on the same offers (evictions and ties included); ``tally_hash``
  is integer-identical.
* The grouped extraction's plain version against the reference's oracle
  (``repro.kernels.ref.slot_extract_grouped_ref``): the m lane and the cell
  count lanes equal; the sum lanes within rtol 2e-5 / atol 1e-2, the
  tolerance the reference holds its own grouped kernel to on these inputs
  (float32 sums of the same terms in another order, with cancellation:
  mixed-sign values and coefficients); tallies ``array_equal`` (an integer
  group column and 0/1 indicators make every tally sum exact in float32).
* ``SlotOLAEngine`` with a grouped table (pinned values, a discovery-only
  slot, an ungrouped slot, a promotion mid-run) beside the reference's
  ``ref`` path: integer state and ``gm`` equal every round, ``g_tal``
  equal, float statistics and per-cell estimates within a relative 1e-5.
* Bit-exact invariants inside the port: grouped == ``group_fanout``;
  grouped under ``residency="stream"`` == packed on ``"ref"``; an ungrouped
  workload is unchanged by group capacity; the fused grouped kernel under
  streaming is refused.
* The workload server on the reference's grouped smoke lane: equal rounds,
  tuples seen and tracked values in the same order, ``GroupResult`` floats
  within a relative 1e-5; top-5 recall on Zipf data.
* State carried across: the reference's state and table, taken mid-run
  after a promotion, continue in the port round for round.
* The grouped kernel's scratch row, on the CPU.
* On the card (marked ``cuda``): the grouped kernel against its plain
  version at the window widths that reach every case of its geometry, and
  three launches on the same inputs giving the same bits (its tracked
  cells against kernel 1 on the fan-out slots: ``chip_smoke.py``).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import engine as j_eng
from repro.core import groupby as jg
from repro.core import queries as jq
from repro.data.formats import AsciiFixedFormat
from repro.data.generator import make_wiki_like as j_wiki
from repro.data.generator import store_dataset as j_store
from repro.kernels import ref as jref
from repro.serve import ola_server as js
from repro_torch.core import engine as t_eng
from repro_torch.core import groupby as tg
from repro_torch.core import queries as tq
from repro_torch.data.generator import make_wiki_like as t_wiki
from repro_torch.data.generator import store_dataset as t_store
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.slot_extract import (
    scratch_lanes,
    slot_extract_cuda,
    tile_count,
    tile_scratch,
)
from repro_torch.kernels.slot_extract_grouped import slot_extract_grouped_cuda
from repro_torch.serve import ola_server as ts

INT_FIELDS = ("scan_m", "offset", "closed", "acc_met", "head", "cur",
              "raw_touched", "stopped", "round", "cpu_bound", "first_est",
              "quarantined", "cached_m")
RTOL = 1e-5


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every test worker collects
    # the same tests whether or not it sees a card
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# data, sketch, hash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,langs,seed", [(1000, 40, 0), (4097, 16, 3),
                                          (256, 1, 9)])
def test_make_wiki_like_matches_reference(t, langs, seed):
    jv, jl = j_wiki(t, num_languages=langs, seed=seed)
    tv, tl = t_wiki(t, num_languages=langs, seed=seed)
    assert np.array_equal(jv, tv) and np.array_equal(jl, tl)


def test_pure_buckets_and_sketch_match_reference():
    rng = np.random.default_rng(0)
    h = 16
    for _ in range(20):
        tal = np.zeros((3, h), np.float32)
        for b in range(h):
            vals = rng.choice([0.0, 1.0, 2.0, 7.0, 39.0], size=rng.integers(
                0, 4)) if rng.random() < 0.5 else np.full(
                rng.integers(0, 6), float(rng.integers(0, 40)))
            tal[:, b] = [len(vals), vals.sum(), (vals * vals).sum()]
        assert tg.pure_buckets(tal) == jg.pure_buckets(tal)
    # offers with evictions and count ties: a capacity-3 sketch, values
    # arriving with equal counts, then a heavier newcomer
    offers = [(1.0, 5.0), (2.0, 5.0), (3.0, 5.0), (4.0, 5.0), (5.0, 9.0),
              (2.0, 0.0), (6.0, 5.0), (1.0, 2.0), (7.0, 11.0), (3.0, 5.0)]
    a, b = tg.GroupSketch(3), jg.GroupSketch(3)
    for v, c in offers:
        a.offer(v, c)
        b.offer(v, c)
        assert (a.counts, a.errors, a.mass) == (b.counts, b.errors, b.mass)
        assert list(a.counts) == list(b.counts)          # insertion order
        for k in (1, 2, 3, 5):
            assert a.top(k) == b.top(k)
        for v2 in (1.0, 3.0, 5.0, 8.0):
            assert a.guaranteed(v2) == b.guaranteed(v2)
        for tracked in ([], [5.0], [1.0, 7.0]):
            for mg in (1, 3, 4):
                assert (tg.promote_values(a, list(tracked), mg)
                        == jg.promote_values(b, list(tracked), mg))


def test_tally_hash_matches_reference():
    rng = np.random.default_rng(1)
    v = np.concatenate([
        (rng.normal(size=2000) * 10.0 ** rng.integers(-3, 30, 2000)),
        rng.integers(-50, 50, 200), [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38,
                                     1e-45, np.inf, -np.inf]]).astype(
        np.float32)
    for salt in (0, 1, 2, 255, 123456789, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1):
        for hb in (2, 128):
            want = np.asarray(jref.tally_hash(
                jnp.asarray(v), jnp.asarray(salt, jnp.uint32), hb))
            got = tref.tally_hash(torch.as_tensor(v), salt, hb).numpy()
            assert np.array_equal(got, want), (salt, hb)
            assert got.min() >= 0 and got.max() < hb


# ---------------------------------------------------------------------------
# the grouped extraction's plain version
# ---------------------------------------------------------------------------

def _grouped_case(seed=0, n=6, m=37, c=6, w=4, b=16, s=3, g=4, langs=5):
    """tests/test_groupby.py's kernel-parity inputs: an integer group
    column, a slot with three tracked values and a live __other__, an
    ungrouped slot and a discovery-only slot."""
    rng = np.random.default_rng(seed)
    codec = AsciiFixedFormat(c)
    vals = rng.uniform(-1e6, 1e6, (n * m, c))
    vals[:, 0] = rng.integers(0, langs, n * m)
    packed = codec.encode(vals).reshape(n, m, codec.record_bytes)
    jw = rng.integers(0, n, w).astype(np.int32)
    idx = rng.integers(0, m, (w, b)).astype(np.int32)
    b_eff = np.array([b, 7, 0, 3][:w], np.int32)
    coeffs = rng.normal(size=(s, c)).astype(np.float32)
    lo = np.full((s, c), -np.inf, np.float32)
    hi = np.full((s, c), np.inf, np.float32)
    lo[:, 1] = rng.uniform(-1e6, 0, s)
    hi[:, 1] = rng.uniform(0, 1e6, s)
    is_count = np.array([0, 1, 0][:s], np.float32)
    gate = np.ones(s, np.float32)
    weights = np.array([1.0, 0.5, 0.77][:s], np.float32)
    gcol = np.array([0, -1, 0][:s], np.int32)
    tracked = min(3, g - 1)
    gval = np.zeros((s, g), np.float32)
    gval[0, :tracked] = np.arange(tracked)
    gact = np.zeros((s, g), np.float32)
    gact[0, :tracked] = 1.0
    gact[0, -1] = 1.0
    if s > 2:
        gact[2, -1] = 1.0
    return (packed, jw, idx, b_eff, coeffs, lo, hi, is_count, gate, weights,
            gcol, gval, gact)


def _check_grouped_ref(case, salt):
    (packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate, wts, gcol, gval,
     gact) = case
    c = coeffs.shape[1]
    j_st, _, j_gs, j_tal = jref.slot_extract_grouped_ref(
        *(jnp.asarray(a) for a in (packed, jw, idx, b_eff, coeffs, lo, hi,
                                   isc, gate, gcol, gval, gact)),
        jnp.asarray(salt, jnp.uint32), num_cols=c, weights=jnp.asarray(wts))
    t_st, t_cols, t_gs, t_tal = ops.slot_extract(
        torch.as_tensor(packed), jw, idx, b_eff, coeffs, lo, hi, isc, gate,
        weights=wts, return_cols=True, gcol=gcol, gval=gval, gact=gact,
        salt=salt)
    got = [t.numpy() for t in (t_st, t_gs, t_tal)]
    want = [np.asarray(a) for a in (j_st, j_gs, j_tal)]
    assert [a.shape for a in got] == [a.shape for a in want]
    assert np.array_equal(got[0][..., 0], want[0][..., 0])       # m lane
    assert np.array_equal(got[1][..., 0], want[1][..., 0])       # cell counts
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=1e-2)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=1e-2)
    np.testing.assert_array_equal(got[2], want[2])               # tallies
    # an ungrouped slot has no cells and no tallies
    for s in np.flatnonzero(gcol < 0):
        assert not got[1][:, s].any() and not got[2][:, s].any()
    # a slot whose __other__ cell is dead (not discovering) tallies nothing
    for s in np.flatnonzero(gact[:, -1] == 0):
        assert not got[2][:, s].any()
    return t_cols


@pytest.mark.parametrize("salt", [7, 0, 2 ** 32 - 1])
def test_grouped_plain_version_matches_reference_oracle(salt):
    case = _grouped_case()
    cols = _check_grouped_ref(case, salt)
    assert cols.shape == (4, 16, 6)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2 ** 16), w=st.integers(1, 4),
       b=st.sampled_from([1, 8, 16, 33]), g=st.integers(2, 6),
       langs=st.integers(1, 9), salt=st.integers(0, 2 ** 32 - 1))
def test_grouped_plain_version_matches_reference_hypothesis(seed, w, b, g,
                                                            langs, salt):
    case = list(_grouped_case(seed=seed, w=w, b=b, g=g, langs=langs))
    rng = np.random.default_rng(seed)
    case[3] = rng.integers(0, b + 1, w).astype(np.int32)         # budgets
    gval, gact = case[11], case[12]
    gval[0, : g - 1] = rng.permutation(max(langs, g))[: g - 1]   # distinct
    gact[0, : g - 1] = rng.integers(0, 2, g - 1)
    _check_grouped_ref(tuple(case), salt)


def test_cpu_grouped_call_launches_nothing():
    before = (slot_extract_cuda.launches, slot_extract_grouped_cuda.launches)
    _check_grouped_ref(_grouped_case(seed=2), 3)
    assert (slot_extract_cuda.launches,
            slot_extract_grouped_cuda.launches) == before
    case = _grouped_case(seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        slot_extract_grouped_cuda(
            *(torch.as_tensor(np.ascontiguousarray(a)) for a in case),
            torch.zeros(1, dtype=torch.int32), 128)


# ---------------------------------------------------------------------------
# engine rounds against the reference
# ---------------------------------------------------------------------------

def _wiki_values(t=2048, langs=6, seed=11):
    return j_wiki(t, num_languages=langs, seed=seed)[0]


@pytest.fixture(scope="module")
def wiki():
    vals = _wiki_values()
    return (vals, j_store(vals, 8, "ascii", uneven=True, seed=11),
            t_store(vals, 8, "ascii", uneven=True, seed=11))


def _grouped_slots(mod):
    """A grouped slot with pinned values, a discovery-only COUNT slot and
    an ungrouped AVG slot."""
    base = mod.Query(agg="sum", expr=mod.Linear((0.0, 1.0, 0.0, 0.0)),
                     pred=mod.Range(3, 0.0, 500.0), epsilon=0.02, name="s")
    return [
        dataclasses.replace(base, group_by=mod.GroupBy(
            col=0, max_groups=4, top_k=2, values=(0.0, 2.0))),
        mod.Query(agg="count", pred=mod.Range(1, 1.0, 1e9), epsilon=0.03,
                  name="c", group_by=mod.GroupBy(col=0, max_groups=4)),
        mod.Query(agg="avg", expr=mod.Linear((0.0, 0.0, 1.0, 0.0)),
                  epsilon=0.01, name="a"),
    ]


def _assert_states(t, j, where, rtol=RTOL):
    for f in INT_FIELDS:
        assert np.array_equal(_np(getattr(t, f)), _np(getattr(j, f))), (
            f"{where}: {f}")
    assert np.array_equal(_np(t.stats.m), _np(j.stats.m)), f"{where}: m"
    assert np.array_equal(_np(t.gm), _np(j.gm)), f"{where}: gm"
    for f in ("ysum", "ysq", "psum"):
        np.testing.assert_allclose(_np(getattr(t.stats, f)),
                                   _np(getattr(j.stats, f)), rtol=rtol,
                                   atol=1e-3, err_msg=f"{where}: {f}")
    for f in ("gys", "gyq", "gps"):
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   rtol=rtol, atol=1e-3,
                                   err_msg=f"{where}: {f}")
    for f in ("t_io", "t_cpu", "budget"):
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   rtol=rtol, err_msg=f"{where}: {f}")


def _assert_reports(trep, jrep, where):
    """Tallies and cell sizes equal; estimates and CI half-widths within a
    relative 1e-5, and so the bounds within 1e-5 of |estimate| + half-width
    (a bound near zero is a difference of two large numbers)."""
    assert np.array_equal(_np(trep.g_tal), _np(jrep.g_tal)), f"{where}: tal"
    assert np.array_equal(_np(trep.g_n), _np(jrep.g_n)), f"{where}: g_n"
    for e, lo, hi in (("g_est", "g_lo", "g_hi"), ("estimate", "lo", "hi")):
        te, je = _np(getattr(trep, e)), _np(getattr(jrep, e))
        th = (_np(getattr(trep, hi)) - _np(getattr(trep, lo))) / 2
        jh = (_np(getattr(jrep, hi)) - _np(getattr(jrep, lo))) / 2
        np.testing.assert_allclose(te, je, rtol=RTOL, atol=1e-3,
                                   err_msg=f"{where}: {e}")
        np.testing.assert_allclose(th, jh, rtol=RTOL, atol=1e-3,
                                   err_msg=f"{where}: {e} half-width")
        scale = RTOL * (np.abs(je) + np.abs(jh)) + 1e-3
        for f in (lo, hi):
            tb, jb = _np(getattr(trep, f)), _np(getattr(jrep, f))
            fin = np.isfinite(jb)
            assert np.array_equal(np.isfinite(tb), fin), f"{where}: {f}"
            assert (np.abs(tb - jb)[fin] <= scale[fin]).all(), f"{where}: {f}"


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_grouped_engine_round_for_round(wiki, backend):
    _, jst_, tst_ = wiki
    jcfg = j_eng.EngineConfig(num_workers=4, seed=5, max_groups=4,
                              cache_cap=16)
    tcfg = t_eng.EngineConfig(num_workers=4, seed=5, max_groups=4,
                              cache_cap=16, extract_backend=backend)
    je = j_eng.SlotOLAEngine(jst_, 3, jcfg)
    te = t_eng.SlotOLAEngine(tst_, 3, tcfg, device="cpu")
    jt = jq.empty_slot_table(3, 4, max_groups=4)
    tt = tq.empty_slot_table(3, 4, max_groups=4, device="cpu")
    plans = ("holistic", "resource_aware", "single_pass")
    for s, (a, b) in enumerate(zip(_grouped_slots(jq), _grouped_slots(tq))):
        jt = jq.slot_table_set(jt, s, jq.encode_slot(a, 4, plan=plans[s],
                                                     max_groups=4))
        tt = tq.slot_table_set(tt, s, tq.encode_slot(b, 4, plan=plans[s],
                                                     max_groups=4))
    jst, tst = je.init_state(), te.init_state()
    for r in range(40):
        if r == 10:
            # a promotion into the discovery slot: two cells go live and
            # __other__ restarts
            gval = np.array([1.0, 3.0, 0.0, 0.0, 0.0], np.float32)
            gact = np.array([1.0, 1.0, 0.0, 0.0, 1.0], np.float32)
            jt = jq.slot_table_set_groups(jt, 1, gval, gact)
            tt = tq.slot_table_set_groups(tt, 1, gval, gact)
            jst = j_eng.zero_group_cells(jst, 1, cells=[4])
            tst = t_eng.zero_group_cells(tst, 1, cells=[4])
        jb = je.budget_ladder(float(jst.budget))
        assert te.budget_ladder(float(tst.budget)) == jb
        jst, jrep = je.round_fn(jb)(jst, jt, je.packed, je.speeds)
        tst, trep = te.round_fn(jb)(tst, tt, te.packed, te.speeds)
        _assert_states(tst, jst, f"round {r}")
        _assert_reports(trep, jrep, f"round {r}")
        if bool(jrep.exhausted):
            break
    assert float(_np(tst.gps)[1, -1].sum()) > 0          # restarted spill
    assert float(_np(trep.g_tal)[1].sum()) > 0           # discovery tallies
    assert not _np(trep.g_tal)[2].any()                  # ungrouped slot


def _drive(engine, table, rounds):
    state = engine.init_state()
    reports = []
    try:
        for _ in range(rounds):
            b = engine.budget_ladder(float(state.budget))
            state, data = engine.round_data(state)
            mode, data = engine.data_mode(data)
            state, rep = engine.round_fn(b, mode)(state, table, data,
                                                  engine.speeds)
            reports.append(rep)
    finally:
        engine.close()
    return state, reports


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_grouped_vs_fanout_bit_exact(wiki, backend):
    """Pinned tracked cells == dedicated fan-out slots through exhaustion:
    the same per-round estimates and bit-identical sufficient statistics,
    and the ``__other__`` spill conserves the base predicate's mass."""
    _, _, store = wiki
    pinned = [0.0, 1.0, 2.0]
    base = tq.Query(agg="sum", expr=tq.Linear((0.0, 1.0, 0.0, 0.0)),
                    pred=tq.Range(3, 0.0, 18.0), epsilon=1e-9)
    gq = dataclasses.replace(base, group_by=tq.GroupBy(
        col=0, max_groups=4, top_k=3, values=pinned))
    fq = tq.group_fanout(base, 0, pinned)
    cfg = t_eng.EngineConfig(num_workers=4, budget_init=64, budget_min=64,
                             budget_max=64, seed=5, cache_cap=16,
                             extract_backend=backend)
    cfg_g = dataclasses.replace(cfg, max_groups=4)
    tg_ = tq.slot_table_set(tq.empty_slot_table(1, 4, max_groups=4), 0,
                            tq.encode_slot(gq, 4, plan="holistic",
                                           max_groups=4))
    tf = tq.empty_slot_table(len(fq), 4)
    for i, q in enumerate(fq):
        tf = tq.slot_table_set(tf, i, tq.encode_slot(q, 4, plan="holistic"))
    sg, rg = _drive(t_eng.SlotOLAEngine(store, 1, cfg_g, device="cpu"), tg_,
                    40)
    sf, rf = _drive(t_eng.SlotOLAEngine(store, len(fq), cfg, device="cpu"),
                    tf, 40)
    assert int(_np(sg.scan_m).sum()) == 2048                  # exhausted
    for a, b in zip(rg, rf):
        assert np.array_equal(_np(a.g_est)[0, :3], _np(b.estimate)[:3],
                              equal_nan=True)
    for i in range(len(pinned)):
        assert np.array_equal(_np(sg.gm)[0, i], _np(sf.stats.m)[i])
        assert np.array_equal(_np(sg.gys)[0, i], _np(sf.stats.ysum)[i])
        assert np.array_equal(_np(sg.gyq)[0, i], _np(sf.stats.ysq)[i])
        assert np.array_equal(_np(sg.gps)[0, i], _np(sf.stats.psum)[i])
    gps = _np(sg.gps)[0]
    assert np.array_equal(gps.sum(axis=0), _np(sg.stats.psum)[0])
    assert float(gps[-1].sum()) > 0.0


def test_grouped_stream_equals_packed_on_ref(wiki):
    """Grouped rounds on the ``"ref"`` composition under streaming
    residency (cache off, and a decoded cache that forces mixed rounds)
    equal the packed rounds bit for bit."""
    _, _, store = wiki
    block = store.max_chunk_tuples * store.codec.num_cols * 4
    runs = []
    for kw in (dict(), dict(residency="stream"),
               dict(residency="stream", decoded_cache_bytes=2 * block)):
        cfg = t_eng.EngineConfig(num_workers=4, seed=5, max_groups=4,
                                 cache_cap=16, extract_backend="ref", **kw)
        tt = tq.empty_slot_table(3, 4, max_groups=4)
        for s, q in enumerate(_grouped_slots(tq)):
            tt = tq.slot_table_set(tt, s, tq.encode_slot(q, 4, max_groups=4))
        runs.append(_drive(t_eng.SlotOLAEngine(store, 3, cfg, device="cpu"),
                           tt, 40))
    (pstate, preps), *rest = runs
    for state, reps in rest:
        assert len(reps) == len(preps)
        for f in t_eng.EngineState._fields:
            a, b = getattr(state, f), getattr(pstate, f)
            if f == "stats":
                for g in ("m", "ysum", "ysq", "psum"):
                    assert torch.equal(getattr(a, g), getattr(b, g)), g
            else:
                assert torch.equal(a, b), f
        for a, b in zip(reps, preps):
            for f in ("g_est", "g_lo", "g_hi", "g_tal", "g_n", "estimate"):
                assert torch.equal(torch.nan_to_num(getattr(a, f)),
                                   torch.nan_to_num(getattr(b, f))), f


def test_fused_grouped_stream_rejected(wiki):
    _, _, store = wiki
    cfg = t_eng.EngineConfig(num_workers=2, max_groups=2, residency="stream")
    with pytest.raises(ValueError, match="packed"):
        t_eng.SlotOLAEngine(store, 1, cfg, device="cpu")
    with pytest.raises(ValueError, match="slot-table"):
        t_eng.OLAEngine(store, [tq.Query("sum")],
                        t_eng.EngineConfig(max_groups=2,
                                           extract_backend="ref"),
                        device="cpu")


# ---------------------------------------------------------------------------
# the workload server
# ---------------------------------------------------------------------------

def test_ungrouped_server_unchanged_by_group_capacity():
    """An ungrouped workload on a server with max_groups=4 is round for
    round bit-identical to the max_groups=0 server."""
    vals = _wiki_values(1024)
    store = t_store(vals, 6, "ascii", uneven=True, seed=11)
    queries = [
        tq.Query(agg="sum", expr=tq.Linear((0.0, 1.0, 0.0, 0.0)),
                 pred=tq.Range(3, 0.0, 12.0), epsilon=0.05),
        tq.Query(agg="count", pred=tq.Range(0, 0.0, 3.0), epsilon=0.08),
        tq.Query(agg="avg", expr=tq.Linear((0.0, 0.0, 1.0, 0.0)),
                 epsilon=0.06),
    ]

    def run(max_groups):
        cfg = t_eng.EngineConfig(num_workers=2, seed=9, max_groups=max_groups)
        srv = ts.OLAWorkloadServer(store, cfg, options=ts.ServerOptions(
            max_slots=2, synopsis_budget_tuples=0), device="cpu")
        for i, q in enumerate(queries):
            srv.submit(q, arrival_t=1e-5 * i)
        trace = []
        res = srv.run(on_round=lambda s: trace.append(
            (int(s.tuples_scanned), _np(s.state.stats.ysum).tobytes(),
             _np(s.state.stats.m).tobytes())))
        return [(r.qid, r.estimate, r.lo, r.hi, r.err, r.tuples_seen,
                 r.rounds_resident, r.groups) for r in res], trace

    assert run(0) == run(4)


def _lane_queries(mod, nq=4):
    """benchmarks/bench_workload.py's grouped lane: SUM over hits or bytes,
    ε from U(0.05, 0.10), GroupBy(col=0, max_groups=8, top_k=5)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(nq):
        col = int(rng.choice([1, 2]))
        eps = float(rng.uniform(0.05, 0.10))
        coeffs = tuple(1.0 if k == col else 0.0 for k in range(4))
        out.append(mod.Query(agg="sum", expr=mod.Linear(coeffs), epsilon=eps,
                             name=f"g{i}-c{col}", group_by=mod.GroupBy(
                                 col=0, max_groups=8, top_k=5)))
    return out


@pytest.fixture(scope="module")
def lane():
    """The grouped smoke lane (8,192 tuples, 12 uneven chunks, 16
    languages, 4 queries, 4 slots) served by the reference."""
    vals = j_wiki(8192, num_languages=16, seed=0)[0]
    srv = js.OLAWorkloadServer(
        j_store(vals, 12, "ascii", uneven=True, seed=0),
        j_eng.EngineConfig(num_workers=4, seed=7, max_groups=8),
        options=js.ServerOptions(max_slots=4, synopsis_budget_tuples=0))
    for i, q in enumerate(_lane_queries(jq)):
        srv.submit(q, arrival_t=1e-4 * i)
    res = srv.run()
    return vals, srv, res


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_grouped_lane_matches_reference(lane, backend):
    vals, jsrv, jres = lane
    tsrv = ts.OLAWorkloadServer(
        t_store(vals, 12, "ascii", uneven=True, seed=0),
        t_eng.EngineConfig(num_workers=4, seed=7, max_groups=8,
                           extract_backend=backend),
        options=ts.ServerOptions(max_slots=4, synopsis_budget_tuples=0),
        device="cpu")
    for i, q in enumerate(_lane_queries(tq)):
        tsrv.submit(q, arrival_t=1e-4 * i)
    tres = tsrv.run()
    assert (tsrv.rounds, tsrv.tuples_scanned) == (jsrv.rounds,
                                                  jsrv.tuples_scanned)
    assert len(tres) == len(jres) == 4
    for a, b in zip(tres, jres):
        assert (a.name, a.rounds_resident, a.tuples_seen) == (
            b.name, b.rounds_resident, b.tuples_seen)
        assert len(a.groups) == len(b.groups)
        for ga, gb in zip(a.groups, b.groups):
            assert ga.is_other == gb.is_other and ga.n == gb.n
            assert (math.isnan(ga.value) and math.isnan(gb.value)
                    or ga.value == gb.value)
            assert ga.decision == gb.decision
            half_a, half_b = (ga.hi - ga.lo) / 2, (gb.hi - gb.lo) / 2
            np.testing.assert_allclose([ga.estimate, half_a, ga.err],
                                       [gb.estimate, half_b, gb.err],
                                       rtol=RTOL)
            scale = RTOL * (abs(gb.estimate) + half_b)
            assert abs(ga.lo - gb.lo) <= scale and abs(ga.hi - gb.hi) <= scale
        np.testing.assert_allclose(a.estimate, b.estimate, rtol=RTOL)
        # the explain trajectory carries each round's cells
        assert a.explain.trajectory[-1].groups is not None


def test_server_discovery_topk_recall_zipf():
    vals = t_wiki(8192, num_languages=16, seed=0)[0]
    store = t_store(vals, 12, "ascii", uneven=True, seed=0)
    srv = ts.OLAWorkloadServer(
        store, t_eng.EngineConfig(num_workers=4, seed=7, max_groups=8),
        options=ts.ServerOptions(max_slots=2, synopsis_budget_tuples=0),
        device="cpu")
    q = tq.Query(agg="sum", expr=tq.Linear((0.0, 1.0, 0.0, 0.0)),
                 epsilon=0.05, group_by=tq.GroupBy(col=0, max_groups=8,
                                                   top_k=5))
    srv.submit(q, arrival_t=0.0)
    res = srv.run(max_rounds=4000)
    assert len(res) == 1 and res[0].groups is not None
    tracked = [g for g in res[0].groups if not g.is_other]
    other = [g for g in res[0].groups if g.is_other]
    assert len(other) == 1 and math.isnan(other[0].value)
    assert 1 <= len(tracked) <= 8
    per_lang = np.bincount(vals[:, 0].astype(int), weights=vals[:, 1])
    true_top = set(np.argsort(-per_lang, kind="stable")[:5].astype(float))
    recall = len(true_top & {g.value for g in tracked}) / 5
    assert recall >= 0.9
    assert other[0].n > 0
    for gres in tracked:
        exact = per_lang[int(gres.value)]
        assert abs(gres.estimate - exact) <= max(0.15 * exact, 1e3), gres


def test_grouped_submit_validation():
    vals = _wiki_values(256)
    store = t_store(vals, 2, "ascii")
    srv = ts.OLAWorkloadServer(store, t_eng.EngineConfig(num_workers=2),
                               options=ts.ServerOptions(max_slots=1),
                               device="cpu")
    q = tq.Query(agg="count", group_by=tq.GroupBy(col=0, max_groups=4))
    with pytest.raises(ValueError, match="max_groups"):
        srv.submit(q, arrival_t=0.0)
    srv2 = ts.OLAWorkloadServer(
        store, t_eng.EngineConfig(num_workers=2, max_groups=2),
        options=ts.ServerOptions(max_slots=1), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        srv2.submit(q, arrival_t=0.0)
    with pytest.raises(TypeError):
        tq.Query("sum", group_by=object())
    with pytest.warns(DeprecationWarning, match="group_by"):
        old = tq.expand_group_by(tq.Query("sum"), 0, [1.0, 2.0])
    assert old == tq.group_fanout(tq.Query("sum"), 0, [1.0, 2.0])


# ---------------------------------------------------------------------------
# state carried across from the reference
# ---------------------------------------------------------------------------

def test_reference_state_continues_in_the_port(lane):
    """The reference server's state and table, taken mid-run after a
    promotion, continue in the port's engine: the next rounds equal the
    reference's own, round for round."""
    vals, _, _ = lane
    jstore = j_store(vals, 12, "ascii", uneven=True, seed=0)
    cfg = dict(num_workers=4, seed=7, max_groups=8)
    jsrv = js.OLAWorkloadServer(jstore, j_eng.EngineConfig(**cfg),
                                options=js.ServerOptions(
                                    max_slots=4, synopsis_budget_tuples=0))
    for i, q in enumerate(_lane_queries(jq)):
        jsrv.submit(q, arrival_t=1e-4 * i)
    while not any(jsrv._slot_groups[s] for s in range(4)
                  if jsrv._slot_groups[s] is not None):
        assert jsrv.step()
    for _ in range(3):                      # a few rounds past the promotion
        jsrv.step()
    tstate = t_eng.state_from_numpy(jsrv.state, device="cpu")
    ttable = tq.slot_table_from_numpy(jsrv.table, device="cpu")
    assert ttable.group_cells == 9 and float(_np(ttable.gact)[:, :-1].sum()) > 0
    te = t_eng.SlotOLAEngine(t_store(vals, 12, "ascii", uneven=True, seed=0),
                             4, t_eng.EngineConfig(**cfg), device="cpu")
    je, jt = jsrv.engine, jsrv.table
    jst = jsrv.state
    _assert_states(tstate, jst, "carried", rtol=0)
    for r in range(30):
        b = je.budget_ladder(float(jst.budget))
        assert te.budget_ladder(float(tstate.budget)) == b
        jst, jrep = je.round_fn(b)(jst, jt, je.packed, je.speeds)
        tstate, trep = te.round_fn(b)(tstate, ttable, te.packed, te.speeds)
        _assert_states(tstate, jst, f"round {r} after the carry")
        _assert_reports(trep, jrep, f"round {r} after the carry")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# window widths that reach every case of the kernel's geometry: a partial
# warp, one warp, a warp and a bit, two warps, one tile, two tiles, the
# engine's budget_max (4096) and twice it
EDGE_B = [1, 8, 31, 33, 64, 256, 257, 4096, 8192]


@pytest.mark.parametrize("b", [8, 257, 4096])
def test_grouped_scratch_row_holds_stats_cells_and_tallies(b):
    # the deployment's shapes: S = 4 slots, G = 9 cells, H = 128 buckets
    lanes = scratch_lanes(4, 9, 128)
    assert lanes == 4 * 4 + 4 * 9 * 4 + 4 * 3 * 128
    scratch = tile_scratch(4, b, lanes, torch.device("cpu"))
    tiles = tile_count(b)
    assert (scratch is None) == (tiles == 1)
    if scratch is not None:
        assert scratch.shape == (4, tiles, lanes)


def _card_case(b, device):
    case = list(_grouped_case(seed=b, m=max(b, 64), b=b))
    case[3] = np.array([b, max(b - 3, 0), 0, b // 2], np.int32)
    # non-negative plan over non-negative data: relative sum bounds hold
    vals_rng = np.random.default_rng(b)
    n, m = case[0].shape[:2]
    vals = vals_rng.uniform(0, 1e6, (n * m, 6))
    vals[:, 0] = vals_rng.integers(0, 5, n * m)
    case[0] = AsciiFixedFormat(6).encode(vals).reshape(n, m, -1)
    case[4] = np.abs(case[4])
    case[5][:, 1], case[6][:, 1] = 1e5, 9e5
    args = [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in case]
    return args, torch.tensor([11], dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", EDGE_B)
def test_grouped_kernel_matches_plain_version_on_the_card(cuda_device, b):
    args, salt = _card_case(b, cuda_device)
    before = slot_extract_grouped_cuda.launches
    got = slot_extract_grouped_cuda(*args, salt, 128, return_cols=True)
    want = tref.slot_extract_grouped_ref(*args[:9], *args[10:], salt,
                                         num_cols=6, return_cols=True,
                                         weights=args[9])
    torch.cuda.synchronize()
    assert slot_extract_grouped_cuda.launches == before + 1
    rtol = (2 * b + 16) * 2.0 ** -24
    for k in (0, 2):
        g, w = got[k].cpu().numpy(), want[k].cpu().numpy()
        assert np.array_equal(g[..., 0], w[..., 0])
        np.testing.assert_allclose(g[..., 1:], w[..., 1:], rtol=rtol, atol=0)
    assert torch.equal(got[3].cpu(), want[3].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [257, 8192])
def test_grouped_repeated_launches_give_the_same_bits_on_the_card(
        cuda_device, b):
    # more than one tile: the last block of each worker folds the tiles and
    # resets its counter; a counter left set would change the next result
    args, salt = _card_case(b, cuda_device)
    runs = [slot_extract_grouped_cuda(*args, salt, 128, return_cols=True)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        for got, first in zip(again, runs[0], strict=True):
            assert torch.equal(got.view(torch.int32),
                               first.view(torch.int32))
