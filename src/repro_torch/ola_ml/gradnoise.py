"""Gradient-noise-scale estimation with bi-level confidence bounds
(counterpart of ``repro.ola_ml.gradnoise``).

The critical-batch-size heuristic (McCandlish et al. 2018) needs
``B_simple = tr(Σ) / |G|²`` — both terms are population aggregates over
examples, so they are OLA estimands: microbatches are *chunks*, examples
are *tuples*.  ``E[|g_b|²]`` is estimated at two batch sizes with Eq.
(1)/(3) bounds and solved for the noise scale, stopping when both CIs are
tight.  Estimator arithmetic around the caller's ``gnorm_fn``: the
statistics are small float32 tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import estimators as est


@dataclasses.dataclass
class NoiseScaleResult:
    b_simple: float
    lo: float
    hi: float
    gnorm_small: float
    gnorm_big: float
    batches_used: int


def estimate_noise_scale(gnorm_fn: Callable[[int, int], float],
                         b_small: int, b_big: int, num_chunks: int = 16,
                         probes_per_chunk: int = 4, epsilon: float = 0.2,
                         confidence: float = 0.9, seed: int = 0
                         ) -> NoiseScaleResult:
    """``gnorm_fn(batch_size, seed) -> |g|²`` on a fresh batch.

    Treats probe groups as chunks (bi-level: groups × probes) so the Eq. (3)
    machinery provides the CI; unbiased |G|² from the two-point identity
    |G|² = (B_b·E|g_b|² − B_s·E|g_s|²) / (B_b − B_s)."""
    sizes = torch.full((num_chunks,), probes_per_chunk, dtype=torch.int32)
    stats_s = est.init_stats(sizes, dtype=torch.float32)
    stats_b = est.init_stats(sizes, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    used = 0
    res = None
    for j in range(num_chunks):
        for _ in range(probes_per_chunk):
            gs = float(gnorm_fn(b_small, int(rng.integers(1 << 30))))
            gb = float(gnorm_fn(b_big, int(rng.integers(1 << 30))))
            used += 1
            for st, g in ((stats_s, gs), (stats_b, gb)):
                st.m[j] += 1
                st.ysum[j] += g
                st.ysq[j] += g * g
                st.psum[j] += 1.0
        if j < 1:
            continue
        es, vs, ok_s = est.avg_estimate(stats_s)
        eb, vb, ok_b = est.avg_estimate(stats_b)
        g2 = (b_big * float(eb) - b_small * float(es)) / (b_big - b_small)
        tr_sigma = ((float(es) - float(eb))
                    / (1.0 / b_small - 1.0 / b_big))
        b_simple = tr_sigma / max(g2, 1e-12)
        # delta-method CI on the ratio via endpoint propagation
        los, his = est.confidence_bounds(es, vs, confidence)
        lob, hib = est.confidence_bounds(eb, vb, confidence)
        cands = []
        for a in (float(los), float(his)):
            for b in (float(lob), float(hib)):
                g2c = (b_big * b - b_small * a) / (b_big - b_small)
                trc = (a - b) / (1.0 / b_small - 1.0 / b_big)
                if g2c > 0:
                    cands.append(trc / g2c)
        lo, hi = (min(cands), max(cands)) if cands else (-np.inf, np.inf)
        res = NoiseScaleResult(b_simple=b_simple, lo=lo, hi=hi,
                               gnorm_small=float(es), gnorm_big=float(eb),
                               batches_used=used)
        if bool(ok_s) and bool(ok_b) and hi - lo <= epsilon * abs(b_simple):
            return res
    return res
