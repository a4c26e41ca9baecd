"""Port parity: ``BiLevelSynopsis`` (its coverage and windows after
``update_from_engine``) against the JAX package's, on the same seeded
extraction cache."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.core.synopsis import BiLevelSynopsis as RefSynopsis
from repro_torch.core.synopsis import BiLevelSynopsis


class _State(NamedTuple):
    cache: object
    scan_m: object
    cached_m: object
    offset: object


def _engine_state(seed, n=24, cap=32, cols=3):
    """An engine's extraction cache: chunks 0..n-1 of which some were never
    sampled, cursors past their samples, no seeded windows."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(40, 100, n).astype(np.int64)
    m = np.minimum(rng.integers(0, 60, n), sizes).astype(np.int32)
    m[rng.random(n) < 0.3] = 0
    cache = rng.standard_normal((n, cap, cols)).astype(np.float32)
    offset = (m + rng.integers(0, 5, n)).astype(np.int32)
    cached_m = np.zeros(n, np.int32)
    schedule = rng.permutation(n).astype(np.int32)
    variances = rng.gamma(2.0, 1.0, n)
    return sizes, _State(cache, m, cached_m, offset), schedule, variances


@pytest.mark.parametrize("budget", [10_000, 200])
def test_coverage_after_update_matches_reference(budget):
    sizes, st, schedule, var = _engine_state(5)
    n, cols = len(sizes), st.cache.shape[2]
    ref = RefSynopsis(n, cols, budget, sizes)
    port = BiLevelSynopsis(n, cols, budget, sizes)
    assert port.coverage == ref.coverage == 0.0
    ref.update_from_engine(st, schedule, var)
    port.update_from_engine(_State(*(torch.as_tensor(a) for a in st)),
                            schedule, var)
    assert 0.0 < port.coverage < 1.0
    assert port.coverage == ref.coverage
    assert port.total_tuples == ref.total_tuples
    assert sorted(port.chunks) == sorted(ref.chunks)
    for j, ch in ref.chunks.items():
        assert port.chunks[j].start == ch.start
        np.testing.assert_array_equal(port.chunks[j].values, ch.values)
