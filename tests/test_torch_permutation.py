"""Port parity: keyed Feistel permutations and the chunk schedule.

The port computes in int64 holding 32-bit patterns (PyTorch has no CPU right
shift for uint32); every output must be integer-identical to the JAX
package's uint32 arithmetic, including cycle walking when the chunk's tuple
count ``M_j`` is below the Feistel width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sampling import permutation as jp
from repro_torch.sampling import permutation as tp


def test_chunk_seed_identical():
    rng = np.random.default_rng(0)
    masters = [0, 1, 7, 2**31 - 1, 2**32 - 1] + list(
        rng.integers(0, 2**32, 5))
    ids = np.arange(300, dtype=np.uint32)
    for m in masters:
        want = np.asarray(jp.chunk_seed(jnp.uint32(m), jnp.asarray(ids)))
        got = tp.chunk_seed(int(m), torch.as_tensor(ids.astype(np.int64)))
        assert np.array_equal(got.numpy(), want.astype(np.int64)), m


def test_mix_wraps_mod_2_32():
    x = np.asarray([0, 1, 0xFFFFFFFF, 0x80000000, 0x12345678, 0xDEADBEEF],
                   np.uint32)
    want = np.asarray(jp._mix32(jnp.asarray(x)))
    got = tp._mix32(torch.as_tensor(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


# (seed, start, count, M_j per lane, width): equal chunks, M_j below the
# width (cycle walking), M_j far below it, windows that wrap past M_j
CASES = [
    (7, [0, 5, 100, 3], 64, [4096, 4096, 4096, 4096], 4096),
    (7, [0, 5, 100, 3], 64, [4000, 2900, 4096, 1500], 4096),
    (123, [17, 0, 999], 32, [1000, 257, 5], 1024),
    (2**32 - 1, [4090, 10, 0], 16, [4096, 4095, 3000], 4096),
    (42, [0, 0], 8, [1, 2], 8),
    (9, [65530, 1], 128, [65536, 40000], 65536),
]


@pytest.mark.parametrize("seed,start,count,mj,width", CASES)
def test_permutation_window_identical(seed, start, count, mj, width):
    n = len(start)
    ids = np.arange(n, dtype=np.uint32) * 13 + 2
    seeds = np.asarray(jp.chunk_seed(jnp.uint32(seed), jnp.asarray(ids)))
    want = np.stack([np.asarray(jp.permutation_window_dyn(
        jnp.uint32(seeds[i]), jnp.int32(start[i]), count, jnp.int32(mj[i]),
        width)) for i in range(n)])
    got = tp.permutation_window_dyn(
        torch.as_tensor(seeds.astype(np.int64)), torch.as_tensor(start),
        count, torch.as_tensor(mj), width)
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy() < np.asarray(mj)[:, None]).all()


def test_walk_is_a_bijection_on_short_chunk():
    # M_j = 700 under a 1024-wide network: the window over [0, M_j) is a
    # permutation of [0, M_j)
    seed = tp.chunk_seed(3, torch.tensor([5]))
    got = tp.permutation_window_dyn(seed, torch.tensor([0]), 700,
                                    torch.tensor([700]), 1024)[0].numpy()
    assert sorted(got.tolist()) == list(range(700))


@pytest.mark.parametrize("master,n", [(0, 1), (7, 64), (2**32 - 1, 129)])
def test_random_chunk_order_identical(master, n):
    assert np.array_equal(tp.random_chunk_order(master, n),
                          jp.random_chunk_order(master, n))
