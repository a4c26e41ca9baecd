"""The rows kernels' block split (``csrc/rows_tile.cuh``), through the
wrappers' Python mirror ``repro_torch.kernels.chunk_agg.rows_split``.

* Every row below a row block's valid count is owned by exactly one
  (block, step, thread) of the kernel's indexing, and no row at or past it.
* A sum's rounding chain (the rows a thread sums, 5 shuffle levels, the
  warps, the P partials of the fold) stays within two thirds of the
  tolerances the smoke and the card tests derive from it:
  ``R/256 + 64`` additions against float64 and ``2R + 16`` against the
  plain version.
* The per-stream tile counters grow to a row-block count past 64, zeroed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import chunk_agg as ca
from repro_torch.kernels.slot_extract import tile_counters

#: blocks the card holds at once: one SM with one block, a small card,
#: 132 SMs at two and at three blocks each (the H100 at C = 16)
SLOTS = (1, 24, 264, 396)
SHAPES = ((128, 65536), (4, 4096), (4, 8), (3, 300), (1, 1))


def _owners(split: ca.RowsSplit, n: int) -> np.ndarray:
    """How many (block, step, thread) of the kernel's indexing take each of
    a row block's first ``split.blocks · split.block_rows`` rows when ``n``
    rows are valid: block p owns rows [p·block_rows, (p+1)·block_rows) cut
    at n, and thread t of step s takes the step's row t when there is one."""
    span = split.blocks * split.block_rows
    seen = np.zeros(span, np.int64)
    for p in range(split.blocks):
        r0 = p * split.block_rows
        nb = max(0, min(split.block_rows, n - r0))
        steps = -(-nb // split.step_rows)
        assert steps <= split.steps
        for s in range(steps):
            nr = min(split.step_rows, nb - s * split.step_rows)
            for t in range(ca.ROWS_THREADS):
                if t < nr:
                    seen[r0 + s * split.step_rows + t] += 1
    return seen


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("l,r", SHAPES)
@pytest.mark.parametrize("c", [4, 16, 20, 40])
def test_every_valid_row_is_owned_once(l, r, c, slots):
    split = ca.rows_split(l, r, c, slots)
    assert 1 <= split.blocks <= ca.MAX_BLOCKS
    assert split.block_rows == split.steps * split.step_rows
    # the launcher's checks: whole steps, every row covered
    assert split.blocks * split.block_rows >= r
    assert (split.blocks - 1) * split.block_rows < r
    for valid in sorted({0, 1, max(r - 3, 0), r}):
        seen = _owners(split, min(valid, r))
        assert np.all(seen[:valid] == 1), (valid, split)
        assert not seen[valid:].any(), (valid, split)


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("l,r", SHAPES)
def test_rounding_chain_stays_inside_the_tolerances(l, r, slots):
    split = ca.rows_split(l, r, 16, slots)
    depth = split.chain_depth
    assert depth == split.steps + 5 + 4 + split.blocks
    assert 3 * depth <= 2 * (r // 256 + 64), (split, depth)
    assert 3 * depth <= 2 * (2 * r + 16), (split, depth)


def test_split_at_the_deployment_shapes():
    """The H100 (132 SMs, three blocks each at C = 16): chunk_agg's 128
    chunks of 65,536 rows run as two waves of 768 blocks of 86 steps;
    round_stats's (4, 4096) as 128 blocks of one step."""
    assert ca.rows_split(128, 65536, 16, 396) == ca.RowsSplit(6, 128, 11008,
                                                               86)
    assert ca.rows_split(4, 4096, 16, 396) == ca.RowsSplit(32, 128, 128, 1)
    assert ca.rows_split(4, 8, 16, 396) == ca.RowsSplit(1, 128, 128, 1)


@pytest.mark.parametrize("c,rows", [(1, 128), (4, 128), (16, 128), (24, 128),
                                    (25, 64), (100, 16), (3072, 1)])
def test_step_rows_fit_a_stage(c, rows):
    assert ca.step_rows(c) == rows
    assert rows * 16 * c <= ca.STAGE_BYTES or rows == 1


def test_rows_split_refuses_empty_shapes():
    for bad in ((0, 8, 16, 4), (4, 0, 16, 4), (4, 8, 0, 4), (4, 8, 16, 0)):
        with pytest.raises(ValueError):
            ca.rows_split(*bad)


def test_tile_counters_grow_to_the_row_blocks():
    """chunk_agg's 128 chunks need 128 counters: the stream's counters
    grow from 64, zeroed, and are shared from then on."""
    dev = torch.device("cpu")
    first = tile_counters(4, dev, stream=-201)
    assert first.numel() == 64
    grown = tile_counters(128, dev, stream=-201)
    assert grown.numel() == 128 and not grown.any()
    assert tile_counters(4, dev, stream=-201) is grown
