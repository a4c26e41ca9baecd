"""Reservoir-style chunk admission order for synopsis construction (Section
6.1; counterpart of ``repro.sampling.reservoir``, numpy only).

The synopsis admits chunks in the random order they are extracted for
estimation, i.e. the committed chunk schedule itself; variance-driven
reallocation replaces classic reservoir eviction.  This module gives the
admission order and a plain Vitter reservoir that tests use as a
behavioural baseline.
"""

from __future__ import annotations

import numpy as np


def reservoir_insertion_order(schedule: np.ndarray,
                              extracted_rounds: np.ndarray) -> np.ndarray:
    """Order in which chunks become candidates for synopsis insertion.

    ``schedule`` is the committed random chunk order;
    ``extracted_rounds[j]`` is the round at which chunk ``schedule[j]``
    produced its first sample.  Ties (same round, the common case with
    lockstep workers) break by schedule position, keeping the prefix
    property."""
    order = np.lexsort((np.arange(len(schedule)), extracted_rounds))
    return schedule[order]


def vitter_reservoir(stream: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Vitter's Algorithm R — baseline oracle for synopsis tests."""
    rng = np.random.default_rng(seed)
    res = list(stream[:k])
    for i in range(k, len(stream)):
        j = rng.integers(0, i + 1)
        if j < k:
            res[j] = stream[i]
    return np.asarray(res)
