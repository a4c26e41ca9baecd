"""Port parity: the streaming data plane — fault taxonomy and injection,
the chunk store's zero-copy read, the parse-once decoded-chunk cache and
the slab prefetcher — against the JAX package's classes on the same stores
and seeds.

Everything here is host-side numpy (faults, cache policy, ring assembly),
so each comparison is exact: the same faults fire, the same retries and
delays are taken, the same chunks are evicted, the same slab bytes and
decoded blocks are produced (the port decodes ASCII with the plain parse on
the CPU, bit-identical to the reference's decode).  Every prefetcher a test
makes is closed, so no reader thread outlives its test.
"""

import time

import numpy as np
import pytest
import torch

from repro.data import chunkstore as jcs
from repro.data import faults as jf
from repro.data import pipeline as jp
from repro.data.generator import make_synthetic_zipf, store_dataset as j_store
from repro_torch.data import chunkstore as tcs
from repro_torch.data import faults as tf
from repro_torch.data import pipeline as tp
from repro_torch.data.generator import store_dataset as t_store
from repro_torch.obs.metrics import MetricsRegistry


def _vals(t=2048, seed=3):
    return make_synthetic_zipf(t, 8, seed=seed)


def _stores(t=2048, chunks=12, seed=3, directory=None):
    vals = _vals(t, seed)
    kw = dict(uneven=True, seed=seed)
    jdir = tdir = None
    if directory is not None:
        jdir, tdir = str(directory / "j"), str(directory / "t")
    return (j_store(vals, chunks, "ascii", directory=jdir, **kw),
            t_store(vals, chunks, "ascii", directory=tdir, **kw))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- faults ----

def test_retry_policy_matches_reference():
    for seed in (0, 11):
        jpol = jf.RetryPolicy(seed=seed)
        tpol = tf.RetryPolicy(seed=seed)
        for j in range(6):
            for a in range(5):
                assert tpol.delay_s(j, a) == jpol.delay_s(j, a)

    def outcome(mod, fails, **kw):
        sleeps = []
        pol = mod.RetryPolicy(sleep=sleeps.append, seed=3, **kw)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise mod.TransientReadError("flaky", chunk_id=5)
            return "ok"

        try:
            out = pol.call(flaky, 5)
        except mod.ChunkLostError as e:
            out = ("lost", e.chunk_id, e.retries,
                   type(e.__cause__).__name__)
        return out, sleeps, calls["n"]

    for fails in (0, 2, 3, 9):
        for kw in (dict(max_attempts=4), dict(max_attempts=8,
                                              deadline_s=0.0)):
            assert outcome(tf, fails, **kw) == outcome(jf, fails, **kw)

    def gone():
        raise tf.ChunkLostError("gone", chunk_id=2)

    with pytest.raises(tf.ChunkLostError):       # not retried
        tf.RetryPolicy(sleep=lambda s: None).call(gone, 2)
    assert tf._unit_hash(7, "lost", 3) == jf._unit_hash(7, "lost", 3)


@pytest.mark.parametrize("cfg", [
    dict(seed=7, transient_rate=0.5, transient_fails=1),
    dict(seed=3, loss_rate=0.3, lost_chunks=(1,)),
    dict(seed=7, corrupt_rate=0.4, corrupt_once=True),
    dict(seed=5, corrupt_chunks=(2, 4)),
    dict(),
], ids=["transient", "loss", "corrupt-once", "corrupt", "zero"])
def test_fault_injector_matches_reference(cfg):
    js, ts = _stores(t=512, chunks=6)
    jinj = jf.FaultInjector(js, jf.FaultConfig(**cfg))
    tinj = tf.FaultInjector(ts, tf.FaultConfig(**cfg))

    def reads(inj, mod):
        out = []
        for _ in range(3):
            for j in range(6):
                try:
                    out.append(inj.chunk_bytes(j).tobytes())
                except mod.FaultError as e:
                    out.append((type(e).__name__, e.chunk_id))
        return out

    assert reads(tinj, tf) == reads(jinj, jf)
    assert tinj.injected == jinj.injected
    for j in range(6):
        for roll in ("chunk_is_lost", "chunk_is_transient",
                     "chunk_is_corrupt", "chunk_has_latency"):
            assert getattr(tinj, roll)(j) == getattr(jinj, roll)(j)
    assert tinj.num_chunks == ts.num_chunks            # delegation


# --------------------------------------------------------- chunk store ----

def test_store_version_read_into_and_cross_open(tmp_path):
    js, ts = _stores(t=512, chunks=4, directory=tmp_path)
    assert ts.content_version == js.content_version == 4
    ts.mark_content_changed()
    assert ts.content_version == 5
    rec = ts.codec.record_bytes
    for j in range(4):
        out = np.zeros((200, rec), np.uint8)
        view = ts.read_chunk_into(j, out)
        np.testing.assert_array_equal(view, js.chunk_bytes(j))
        assert view.base is out or view.base is out.base
    # a store written by either package opens in the other
    jj = jcs.ChunkStore.open(str(tmp_path / "t"), "dataset")
    tt = tcs.ChunkStore.open(str(tmp_path / "j"), "dataset")
    for j in range(4):
        np.testing.assert_array_equal(jj.chunk_bytes(j), tt.chunk_bytes(j))
    # the zero-copy read is CRC-checked like chunk_bytes
    path = tt.meta[1].path
    blob = bytearray(open(path, "rb").read())
    blob[9] ^= 0x10
    open(path, "wb").write(bytes(blob))
    with pytest.raises(tf.CorruptChunkError) as ei:
        tt.read_chunk_into(1, np.zeros((200, rec), np.uint8))
    assert ei.value.chunk_id == 1
    open(path, "wb").write(bytes(blob[:-3]))
    with pytest.raises(tf.CorruptChunkError, match="short read"):
        tt.read_chunk_into(1, np.zeros((200, rec), np.uint8))
    # evict/cache only move disk-backed chunks in and out of memory
    tt.cache(0)
    assert tt._chunks[0] is not None
    tt.evict(0)
    assert tt._chunks[0] is None
    mem = t_store(_vals(256), 2, "ascii")
    mem.evict(0)
    assert mem._chunks[0] is not None


# ------------------------------------------------------- decoded cache ----

def test_decoded_cache_sequences_match_reference():
    rng = np.random.default_rng(0)
    for budget, cost in ((4096, 1.0), (20_000, 3360.0), (1 << 20, 32.0)):
        jc = jp.DecodedChunkCache(budget, cost_per_tuple=cost)
        tc = tp.DecodedChunkCache(budget, cost_per_tuple=cost)
        for step in range(300):
            op = rng.integers(0, 10)
            j = int(rng.integers(0, 12))
            if op < 5:
                blk = np.full((int(rng.integers(1, 90)), 8), step, np.float32)
                kw = {} if op else dict(cost_per_tuple=float(step % 7 + 1))
                assert tc.put(j, blk, **kw) == jc.put(j, blk, **kw)
            elif op < 9:
                a, b = tc.get(j), jc.get(j)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            else:
                assert tc.drop(j) == jc.drop(j)
            assert sorted(tc._blocks) == sorted(jc._blocks)
            assert (tc.bytes_cached, tc.evictions, tc.tuples_cached,
                    len(tc)) == (jc.bytes_cached, jc.evictions,
                                 jc.tuples_cached, len(jc))
        tc.check_version(1)
        tc.check_version(1)
        assert len(tc) > 0
        tc.check_version(2)                # a content bump clears it
        assert len(tc) == 0 and tc.bytes_cached == 0


# ---------------------------------------------------------- prefetcher ----

def _pf_pair(js, ts, **kw):
    return (jp.SlabPrefetcher(js, **kw),
            tp.SlabPrefetcher(ts, device="cpu", **kw))


@pytest.mark.parametrize("decoded", [0, 1 << 22, 10_000])
def test_assemble_matches_reference(tmp_path, decoded):
    js, ts = _stores(t=1024, chunks=8, directory=tmp_path)
    jpf, tpf = _pf_pair(js, ts, num_workers=3, row_multiple=64, lookahead=2,
                        decoded_cache_bytes=decoded)
    try:
        assert tpf._direct_readinto and tpf.rows_max % 64 == 0
        assert tpf.slab_shape == jpf.slab_shape
        rng = np.random.default_rng(1)
        for r in range(12):
            ids = rng.choice(8, size=3, replace=False)
            act = rng.random(3) < 0.8
            a, b = tpf.assemble(ids, act), jpf.assemble(ids, act)
            if not decoded:
                assert a.dtype == torch.uint8 and a.device.type == "cpu"
                np.testing.assert_array_equal(_np(a), _np(b))
                continue
            assert len(a) == 4 and a[3] == b[3]      # all_decoded flag
            for x, y in zip(a[:3], b[:3]):
                np.testing.assert_array_equal(_np(x), _np(y))
            assert tpf.decoded_fraction() == jpf.decoded_fraction()
        want = jpf.counters()
        got = tpf.counters()
        for k in ("slabs_built", "decoded_hits", "decoded_misses",
                  "decoded_fills", "extract_tuples_avoided",
                  "decoded_evictions", "decoded_bytes_cached"):
            assert got.get(k) == want.get(k), k
        if decoded:
            assert tpf.drop_decoded(range(8)) == jpf.drop_decoded(range(8))
            assert tpf.decoded_fraction() == 0.0
    finally:
        tpf.close()
        jpf.close()
    assert not tpf._reader.is_alive()


def test_all_decoded_round_skips_the_raw_ring(tmp_path):
    _, ts = _stores(t=512, chunks=4, directory=tmp_path)
    pf = tp.SlabPrefetcher(ts, num_workers=2, lookahead=2, device="cpu",
                           decoded_cache_bytes=1 << 22)
    try:
        act = np.array([True, True])
        first = pf.assemble(np.array([0, 1]), act)
        second = pf.assemble(np.array([1, 0]), act)
        assert first[3] is False and second[3] is True
        assert second[0].shape == (2, 0, ts.codec.record_bytes)
        assert bool(second[2].all())
        assert pf.extract_tuples_avoided == int(ts.chunk_sizes[:2].sum())
        # the decoded slab holds each worker's parsed chunk, zero-padded
        dec = second[1].numpy()
        for w, j in enumerate((1, 0)):
            rows = int(ts.chunk_sizes[j])
            want = ts.codec.decode_ref(torch.from_numpy(
                ts.chunk_bytes(j))).numpy()
            np.testing.assert_array_equal(dec[w, :rows], want)
            assert not dec[w, rows:].any()
    finally:
        pf.close()


def test_readinto_is_off_under_store_wrappers():
    js, ts = _stores(t=512, chunks=4)
    inj = tf.FaultInjector(ts, tf.FaultConfig())
    direct = tp.SlabPrefetcher(ts, num_workers=2, lookahead=2, device="cpu")
    wrapped = tp.SlabPrefetcher(inj, num_workers=2, lookahead=2,
                                device="cpu")
    try:
        assert direct._direct_readinto and not wrapped._direct_readinto
        a = direct.assemble(np.array([0, 1]), np.array([True, True]))
        b = wrapped.assemble(np.array([0, 1]), np.array([True, True]))
        assert torch.equal(a, b)
    finally:
        direct.close()
        wrapped.close()


def test_prefetch_hints_warm_a_bounded_cache():
    _, ts = _stores(t=512, chunks=8)
    pf = tp.SlabPrefetcher(ts, num_workers=2, max_cached_chunks=3,
                           device="cpu")
    try:
        pf.prefetch(range(5))
        deadline = time.time() + 10.0
        while pf.chunk_reads < 5 and time.time() < deadline:
            time.sleep(0.01)
        assert pf.chunk_reads == 5 and len(pf._cache) <= 3
        reads = pf.chunk_reads
        pf.assemble(np.array([4, 3]), np.array([True, True]))
        assert pf.chunk_reads == reads     # warm chunks: no re-read
    finally:
        pf.close()


def test_retries_heal_corruption_and_exhaust_to_lost(tmp_path):
    js, ts = _stores(t=256, chunks=4, directory=tmp_path)
    no_sleep = dict(sleep=lambda s: None)
    outcomes = []
    for mod, pmod, store in ((tf, tp, ts), (jf, jp, js)):
        heal = mod.FaultInjector(store, mod.FaultConfig(
            seed=7, corrupt_chunks=(2,), corrupt_once=True))
        lost = mod.FaultInjector(store, mod.FaultConfig(
            seed=7, corrupt_chunks=(1,)))
        kw = {} if pmod is jp else dict(device="cpu")
        a = pmod.SlabPrefetcher(heal, num_workers=2, lookahead=2,
                                retry=mod.RetryPolicy(max_attempts=4,
                                                      **no_sleep), **kw)
        b = pmod.SlabPrefetcher(lost, num_workers=2, lookahead=2,
                                retry=mod.RetryPolicy(max_attempts=2,
                                                      **no_sleep), **kw)
        try:
            slab = _np(a.assemble(np.array([2, 3]), np.array([True, True])))
            with pytest.raises(mod.ChunkLostError) as ei:
                b.assemble(np.array([1, 0]), np.array([True, True]))
            outcomes.append((slab.tobytes(), a.read_retries, a.chunk_reads,
                             dict(heal.injected), ei.value.chunk_id,
                             type(ei.value.__cause__).__name__,
                             b.read_retries))
        finally:
            a.close()
            b.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == 1 and outcomes[0][4] == 1


def test_reader_stashes_failures_counters_and_close():
    _, ts = _stores()
    inj = tf.FaultInjector(ts, tf.FaultConfig(seed=7, lost_chunks=(4,)))
    pf = tp.SlabPrefetcher(inj, num_workers=2, lookahead=2, device="cpu",
                           retry=tf.RetryPolicy(max_attempts=2,
                                                sleep=lambda s: None))
    reg = MetricsRegistry()
    pf.bind_metrics(reg)
    try:
        pf.prefetch([4, 0])
        deadline = time.time() + 10.0
        while (pf.read_failures < 1 or pf.chunk_reads < 1) \
                and time.time() < deadline:
            time.sleep(0.01)
        assert pf.read_failures == 1 and 4 in pf.read_errors
        assert isinstance(pf.read_errors[4], tf.ChunkLostError)
        snap = reg.snapshot()
        assert snap["prefetch_read_failures"] == 1
        assert snap["prefetch_chunk_reads"] == pf.chunk_reads
    finally:
        pf.close()
    assert not pf._reader.is_alive()
    assert pf.counters()["read_failures"] == 1       # close keeps counters
    pf.reset_counters()
    assert all(v == 0 for k, v in pf.counters().items())


def test_prefetcher_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ts = _stores(t=256, chunks=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.SlabPrefetcher(ts, num_workers=2)
    with pytest.raises(ValueError, match="CUDA"):
        tp.device_resident_bytes("cpu")
    assert tp.peak_host_rss_bytes() > 0


class _PacedStore:
    """Store proxy whose raw reads take a fixed wall time (a slow disk)."""

    def __init__(self, store, read_delay_s: float):
        self._store = store
        self._delay = read_delay_s

    def __getattr__(self, name):
        return getattr(self._store, name)

    def chunk_bytes(self, j):
        time.sleep(self._delay)
        return self._store.chunk_bytes(j)


@pytest.mark.parametrize("adaptive", [True, False])
def test_adaptive_lookahead_follows_read_time(adaptive):
    """A store whose reads are slow against the round cadence drives the
    adaptive lookahead above its base (within the ceiling the host cache is
    provisioned for); without ``adaptive`` it never moves."""
    _, ts = _stores(t=2048, chunks=12)
    pf = tp.SlabPrefetcher(_PacedStore(ts, read_delay_s=0.05), num_workers=2,
                           lookahead=2, adaptive=adaptive, device="cpu")
    try:
        for r in range(6):
            pf.assemble(np.arange(12)[2 * r:2 * r + 2], np.ones(2, bool))
        if adaptive:
            assert 2 < pf.lookahead <= pf.max_lookahead
            assert pf.capacity >= 2 * pf.num_workers + pf.max_lookahead
        else:
            assert pf.lookahead == 2
    finally:
        pf.close()
