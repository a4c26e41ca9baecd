"""Port parity: the ML plane's OLA pieces against the JAX package, on the
CPU.

* ``feistel_permute`` / ``permutation_window`` (the static-width
  variants) integer-equal to the reference's for M = 1, 2, odd sizes,
  powers of two ± 1 and ~10⁵, several keys and window starts.
* ``reservoir_insertion_order`` and ``vitter_reservoir`` equal.
* ``SyntheticCorpus``: token payloads, ``batches()`` and every metadata
  chunk's bytes equal for a seed; ``standard_ingest_queries`` the same
  queries.
* ``ola_eval`` on tests/test_ola_ml.py's two cases: ``shards_used`` and
  ``examples_used`` equal, the estimate and bounds within a float32
  relative 1e-6 (the statistics are float32 in both; the batch sums are
  float64 sums in other orders, rounded to float32); a metric that returns
  tensors gives the same answer as one that returns numpy arrays.
* ``IngestGate`` on test_ingest_gate_separates_segments's corpus: the same
  decisions, failed queries and ``tuples_ratio`` for every segment.
* ``estimate_noise_scale`` on its test's input: equal results; with a
  target so tight that every chunk runs, the same probe count and the
  estimates within a float32 relative 1e-6 (the estimators sum the twelve
  chunks in another order), ``b_simple`` and its bounds within 1e-5 (the
  two-point identity's difference of the two estimates amplifies their
  rounding about (E_s + E_b) / (E_s − E_b) ≈ 5-fold).
* The z-score of ``_local_ok`` and of the bounds: the port's float32
  ``ndtri`` (``estimators.z_score``) is within one float32 ulp of the
  reference's at the confidences tried (the two libraries' float32
  rational approximations round differently; both are a few ulps from
  the true quantile).
* Entry points default to CUDA (raise without a card); on the card
  (marked ``cuda``) ``ola_eval`` and ``IngestGate`` give the CPU's
  outcomes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineConfig as JConfig
from repro.data.corpus import SyntheticCorpus as JCorpus
from repro.data.corpus import standard_ingest_queries as j_queries
from repro.ola_ml.eval_ola import ola_eval as j_eval
from repro.ola_ml.gradnoise import estimate_noise_scale as j_noise
from repro.ola_ml.verify import IngestGate as JGate
from repro.sampling import permutation as jp
from repro.sampling import reservoir as jr
from repro_torch.core import estimators as TE
from repro_torch.core.engine import EngineConfig as TConfig
from repro_torch.data.corpus import SyntheticCorpus as TCorpus
from repro_torch.data.corpus import standard_ingest_queries as t_queries
from repro_torch.ola_ml import IngestGate as TGate
from repro_torch.ola_ml import ola_eval as t_eval
from repro_torch.ola_ml.gradnoise import estimate_noise_scale as t_noise
from repro_torch.sampling import permutation as tp
from repro_torch.sampling import reservoir as tr

SIZES = [1, 2, 3, 5, 7, 8, 9, 15, 16, 17, 31, 33, 63, 64, 65, 255, 257, 1000,
         1023, 1024, 1025, 4095, 4097, 65535, 65537, 100_003]


# ---------------------------------------------------------------------------
# permutations and reservoirs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", SIZES)
def test_feistel_permute_integer_equal(m):
    for master, chunk in ((0, 0), (7, 3), (2 ** 31 - 5, 12_345)):
        jkey = jp.chunk_seed(master, chunk)
        tkey = tp.chunk_seed(master, chunk)
        want = np.asarray(jp.feistel_permute(jkey, jnp.arange(m), m))
        got = tp.feistel_permute(tkey, torch.arange(m), m)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want)
        if m > 1:
            assert np.array_equal(np.sort(want), np.arange(m))
    # any index shape
    idx = np.arange(min(m, 12)).reshape(-1, 1)
    assert np.array_equal(
        tp.feistel_permute(tp.chunk_seed(1, 2), torch.as_tensor(idx),
                           m).numpy(),
        np.asarray(jp.feistel_permute(jp.chunk_seed(1, 2), jnp.asarray(idx),
                                      m)))


@pytest.mark.parametrize("m", [1, 2, 7, 64, 65, 4097, 100_003])
def test_permutation_window_integer_equal(m):
    for start, count in ((0, 1), (0, 32), (m - 1, 5), (3 * m + 2, 64),
                         (m // 2, 2 * m + 3)):
        key = 11
        want = np.asarray(jp.permutation_window(
            jp.chunk_seed(key, 4), start, count, m))
        got = tp.permutation_window(tp.chunk_seed(key, 4), start, count, m)
        assert np.array_equal(got.numpy(), want), (start, count)


def test_reservoir_equal():
    rng = np.random.default_rng(0)
    sched = rng.permutation(40).astype(np.int32)
    rounds = rng.integers(0, 6, 40)
    assert np.array_equal(tr.reservoir_insertion_order(sched, rounds),
                          jr.reservoir_insertion_order(sched, rounds))
    stream = rng.normal(size=500)
    for k, seed in ((1, 0), (10, 3), (499, 1), (600, 2)):
        assert np.array_equal(tr.vitter_reservoir(stream, k, seed),
                              jr.vitter_reservoir(stream, k, seed))


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------

def _corpora(**kw):
    return JCorpus(**kw), TCorpus(**kw)


def test_corpus_equal():
    kw = dict(vocab=1000, num_segments=4, docs_per_segment=96, doc_len=24,
              meta_chunks=5, poison_every=3, seed=2)
    jc, tc = _corpora(**kw)
    assert len(jc.segments) == len(tc.segments)
    for a, b in zip(jc.segments, tc.segments):
        assert (a.index, a.poison) == (b.index, b.poison)
        assert np.array_equal(a.tokens, b.tokens)
        assert a.tokens.dtype == b.tokens.dtype
        assert np.array_equal(a.meta_store.chunk_sizes,
                              b.meta_store.chunk_sizes)
        for j in range(a.meta_store.num_chunks):
            assert np.array_equal(a.meta_store.chunk_bytes(j),
                                  b.meta_store.chunk_bytes(j))
        for batch, seq, steps in ((3, 10, 2), (2, 23, 2), (4, 60, 3)):
            for x, y in zip(jc.batches(a, batch, seq, steps, seed=1),
                            tc.batches(b, batch, seq, steps, seed=1)):
                assert x.keys() == y.keys()
                for k in x:
                    assert np.array_equal(x[k], y[k]) and \
                        x[k].dtype == y[k].dtype
    for a, b in zip(j_queries(0.03), t_queries(0.03)):
        assert (a.agg, a.name, a.epsilon, a.having.op, a.having.threshold,
                a.expr.index) == (b.agg, b.name, b.epsilon, b.having.op,
                                  b.having.threshold, b.expr.index)


# ---------------------------------------------------------------------------
# ola_eval, the ingest gate, the noise scale
# ---------------------------------------------------------------------------

def _eval_cases():
    rng = np.random.default_rng(0)
    early = [rng.normal(5.0, 1.0, size=rng.integers(300, 500))
             for _ in range(20)]
    rng = np.random.default_rng(1)
    tight = [rng.normal(0.0, 50.0, 100) for _ in range(4)]
    return [(early, dict(epsilon=0.02, seed=3)),
            (tight, dict(epsilon=1e-9, seed=0, max_examples=10_000))]


@pytest.mark.parametrize("case", [0, 1])
def test_ola_eval_equal(case):
    shards, kw = _eval_cases()[case]
    want = j_eval(lambda x: x, shards, **kw)
    got = t_eval(lambda x: x, shards, device="cpu", **kw)
    assert (got.shards_used, got.examples_used, got.total_examples) == \
        (want.shards_used, want.examples_used, want.total_examples)
    for f in ("estimate", "lo", "hi"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-6)
    assert got.error_ratio == pytest.approx(want.error_ratio, rel=1e-5,
                                            abs=1e-12)
    if case == 0:
        assert got.examples_used < got.total_examples
    else:
        assert got.examples_used == got.total_examples
    # a metric that returns tensors, over tensor shards
    again = t_eval(lambda x: x * 1.0, [torch.as_tensor(s) for s in shards],
                   device="cpu", **kw)
    assert again == got


def test_z_score_within_one_ulp_of_reference():
    for c in (0.8, 0.9, 0.95, 0.99, 0.999):
        want = np.float32(jax.scipy.special.ndtri((1 + c) / 2))
        got = np.float32(TE.z_score(c, torch.float32))
        assert abs(got - want) <= np.spacing(want), c


def test_ingest_gate_equal():
    kw = dict(vocab=128, num_segments=4, docs_per_segment=256, doc_len=8,
              poison_every=2, seed=5)
    jc, tc = _corpora(**kw)
    cfg = dict(num_workers=2, strategy="resource_aware", budget_init=32,
               seed=1)
    jg = JGate(j_queries(0.05), config=JConfig(**cfg))
    tg = TGate(t_queries(0.05), config=TConfig(**cfg), device="cpu")
    for a, b in zip(jc.segments, tc.segments):
        dj, dt = jg.check(a.meta_store), tg.check(b.meta_store)
        assert (dt.admitted, dt.failed_query, dt.tuples_ratio) == \
            (dj.admitted, dj.failed_query, dj.tuples_ratio)
        assert dt.admitted == (not b.poison)
        assert [int(r.decisions[0]) for r in dt.results] == \
            [int(r.decisions[0]) for r in dj.results]


def _gnorm_fn(batch_size, seed):
    r = np.random.default_rng(seed)
    return 4.0 + 8.0 / batch_size + r.normal(0, 0.05)


def test_noise_scale_equal():
    kw = dict(b_small=4, b_big=64, num_chunks=12, probes_per_chunk=4,
              epsilon=0.5, seed=0)
    want = j_noise(_gnorm_fn, **kw)
    got = t_noise(_gnorm_fn, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # a tight target runs every chunk
    kw["epsilon"] = 1e-9
    want = j_noise(_gnorm_fn, **kw)
    got = t_noise(_gnorm_fn, **kw)
    assert got.batches_used == want.batches_used == 48
    for f in ("gnorm_small", "gnorm_big"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-6)
    for f in ("b_simple", "lo", "hi"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-5)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_eval(lambda x: x, [np.ones(4), np.ones(4)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TGate(t_queries(0.05))


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_cpu(cuda_device):
    shards, kw = _eval_cases()[0]
    a = t_eval(lambda x: x, shards, device="cpu", **kw)
    b = t_eval(lambda x: x, shards, device=cuda_device, **kw)
    assert (a.shards_used, a.examples_used) == (b.shards_used,
                                                b.examples_used)
    assert b.estimate == pytest.approx(a.estimate, rel=1e-6)
    _, tc = _corpora(vocab=128, num_segments=4, docs_per_segment=256,
                     doc_len=8, poison_every=2, seed=5)
    cfg = TConfig(num_workers=2, strategy="resource_aware", budget_init=32,
                  seed=1)
    for seg in tc.segments:
        dc = TGate(t_queries(0.05), config=cfg, device="cpu").check(
            seg.meta_store)
        dg = TGate(t_queries(0.05), config=cfg, device=cuda_device).check(
            seg.meta_store)
        assert (dg.admitted, dg.failed_query, dg.tuples_ratio) == \
            (dc.admitted, dc.failed_query, dc.tuples_ratio)
