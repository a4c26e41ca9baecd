"""OLA-based evaluation with early termination (counterpart of
``repro.ola_ml.eval_ola``).

Estimating a validation metric to ±ε is a SUM/COUNT query over eval
shards: shards are *chunks* (visited in a committed random order — the
no-inspection-paradox queue matters here because shard eval time
correlates with content length), and per-example metrics are *tuples*.
Bi-level sampling stops the eval as soon as the CI is tight enough —
typically a small fraction of the eval set for loss-scale metrics.

This reuses Eq. (1)/(3) directly on model outputs: the per-chunk
sufficient statistics come from batched forward passes instead of raw-byte
EXTRACT.  The statistics live on the entry point's device (CUDA unless the
caller says otherwise); each batch adds to them in place and reads the
estimate back to the host once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import estimators as est
from repro_torch.device import resolve_device
from repro_torch.sampling.permutation import (chunk_seed, feistel_permute,
                                              random_chunk_order)


@dataclasses.dataclass
class OlaEvalResult:
    estimate: float          # mean metric over the eval set
    lo: float
    hi: float
    error_ratio: float
    shards_used: int
    examples_used: int
    total_examples: int


def ola_eval(metric_fn: Callable, shards: list, epsilon: float = 0.02,
             confidence: float = 0.95, batch: int = 64, seed: int = 0,
             max_examples: Optional[int] = None,
             device=None) -> OlaEvalResult:
    """``metric_fn(examples) -> per-example metric`` (a numpy array or a
    tensor); ``shards`` is a list of example arrays (numpy arrays or
    tensors, leading dim = examples).  Returns the ε-accurate mean.

    Shards are visited in a committed random order; inside a shard,
    examples follow the shard's keyed permutation in ``batch``-sized rounds
    (the engine's budget analog).  Stops when the AVG ratio-estimator CI
    meets ε."""
    dev = resolve_device(device)
    n = len(shards)
    sizes = np.asarray([len(s) for s in shards], np.int64)
    order = random_chunk_order(seed, n)
    stats = est.init_stats(torch.as_tensor(sizes, dtype=torch.int32,
                                           device=dev), dtype=torch.float32)
    z = float(est.z_score(confidence, torch.float32))

    used = 0
    shards_used = 0
    offset = np.zeros(n, np.int64)
    result = None
    for pos in range(n):
        j = int(order[pos])
        shards_used += 1
        mj = int(sizes[j])
        key = chunk_seed(seed, j)
        while offset[j] < mj:
            take = min(batch, mj - int(offset[j]))
            idx = feistel_permute(
                key, torch.arange(int(offset[j]), int(offset[j]) + take), mj)
            shard = shards[j]
            examples = (shard[idx.numpy()] if isinstance(shard, np.ndarray)
                        else shard[idx.to(shard.device)])
            vals = torch.as_tensor(metric_fn(examples), device=dev).to(
                torch.float64)
            offset[j] += take
            used += take
            # the reference adds float64 sums into float32 statistics
            stats.m[j] += take
            stats.ysum[j] += vals.sum().to(torch.float32)
            stats.ysq[j] += (vals ** 2).sum().to(torch.float32)
            stats.psum[j] += float(take)
            r, v, ok = est.avg_estimate(stats)
            lo, hi = est.confidence_bounds(r, v, confidence)
            err = est.error_ratio(r, lo, hi)
            # one read a batch: the estimate and shard j's statistics
            (r_, lo_, hi_, err_, ok_, m_j, ys_j, yq_j) = torch.stack([
                t.to(torch.float64) for t in (
                    r, lo, hi, err, ok, stats.m[j], stats.ysum[j],
                    stats.ysq[j])]).tolist()
            result = OlaEvalResult(
                estimate=r_, lo=lo_, hi=hi_, error_ratio=err_,
                shards_used=shards_used, examples_used=used,
                total_examples=int(sizes.sum()))
            if bool(ok_) and err_ <= epsilon and shards_used >= 2:
                return result
            if max_examples and used >= max_examples:
                return result
            # local accuracy met for this shard? move to the next (Theorem 3)
            if _local_ok(m_j, mj, ys_j, yq_j, z, epsilon):
                break
    return result


def _local_ok(m: float, big_m: int, ys: float, yq: float, z: float,
              epsilon: float) -> bool:
    """Shard-local stop (Theorem 3) on float64 copies of the shard's
    float32 statistics.  ``z`` is the float32 ``ndtri((1 + c) / 2)`` of
    ``estimators.z_score``, as in the reference (torch's float32 ``ndtri``
    may sit one float32 ulp from XLA's, so the two stop differently only
    when the two sides agree to ~1e-7)."""
    if m < 2:
        return False
    if m >= big_m:
        return True
    ss = max(yq - ys * ys / m, 0.0)
    v = (big_m / m) * (big_m - m) / (m - 1.0) * ss
    yhat = big_m / m * ys
    return 2 * z * np.sqrt(v) <= epsilon * max(abs(yhat), 1e-12)
