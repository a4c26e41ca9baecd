"""Bi-level sampling estimators — paper Section 4.3, Eq. (1), (2), (3)
(counterpart of ``repro.core.estimators``).

Everything is computed from the per-chunk sufficient statistics of Table 1
(``M_j``, ``m_j``, ``y'_j``, ``y''_j``, ``p_j``), held as tensors of shape
``(..., N)``; chunks with ``m == 0`` are outside the sample and masked out.
``m`` may carry leading per-slot dimensions, broadcasting against ``ysum``.
Functions compute in the dtype of their inputs (float32 in the engine).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class BiLevelStats(NamedTuple):
    """Per-chunk-slot sufficient statistics.

    ``M`` is ``(N,)``; ``m`` is ``(N,)`` or per-slot ``(S, N)``; ``ysum``,
    ``ysq``, ``psum`` are ``(..., N)``.  ``n_total``/``m_total`` are the
    table's chunk and tuple counts (Python ints, or 0-d tensors when the
    engine substitutes a surviving population).
    """

    M: torch.Tensor
    m: torch.Tensor
    ysum: torch.Tensor
    ysq: torch.Tensor
    psum: torch.Tensor
    n_total: Union[int, torch.Tensor]
    m_total: Union[int, torch.Tensor]

    @property
    def in_sample(self) -> torch.Tensor:
        return self.m > 0

    @property
    def n(self) -> torch.Tensor:
        """|U'| — chunks currently in the sample (per leading dim)."""
        return torch.sum(self.in_sample.to(torch.int32), dim=-1)

    def merge(self, other: "BiLevelStats") -> "BiLevelStats":
        """Combine disjoint samples of the same table (cross-worker add)."""
        return BiLevelStats(
            M=self.M,
            m=self.m + other.m,
            ysum=self.ysum + other.ysum,
            ysq=self.ysq + other.ysq,
            psum=self.psum + other.psum,
            n_total=self.n_total,
            m_total=self.m_total,
        )


def init_stats(chunk_sizes: torch.Tensor, query_shape: tuple = (),
               dtype=torch.float32, m_total=None) -> BiLevelStats:
    """Fresh all-zero statistics for a table with the given chunk sizes."""
    n = int(chunk_sizes.shape[0])
    dev = chunk_sizes.device
    total = int(chunk_sizes.sum()) if m_total is None else int(m_total)
    return BiLevelStats(
        M=chunk_sizes,
        m=torch.zeros((n,), dtype=torch.int32, device=dev),
        ysum=torch.zeros(query_shape + (n,), dtype=dtype, device=dev),
        ysq=torch.zeros(query_shape + (n,), dtype=dtype, device=dev),
        psum=torch.zeros(query_shape + (n,), dtype=dtype, device=dev),
        n_total=n,
        m_total=total,
    )


def _f(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(like.dtype)


def chunk_estimates(stats: BiLevelStats) -> torch.Tensor:
    """Per-chunk unbiased estimator ŷ_j = (M_j / m_j) · y'_j (zero off-sample)."""
    m_safe = torch.clamp(stats.m, min=1)
    yhat = _f(stats.M, stats.ysum) / _f(m_safe, stats.ysum) * stats.ysum
    return torch.where(stats.in_sample, yhat, torch.zeros_like(yhat))


def tau_hat(stats: BiLevelStats) -> torch.Tensor:
    """Eq. (1): τ̂ = (N / n) Σ_{j∈U'} ŷ_j."""
    n = torch.clamp(stats.n, min=1).to(stats.ysum.dtype)
    big_n = _f(stats.n_total, stats.ysum)
    return big_n / n * torch.sum(chunk_estimates(stats), dim=-1)


def _cov_hat(stats: BiLevelStats, sum_a, sum_b, cross):
    """Eq. (3)-shaped unbiased (co)variance estimator -> ``(cov, valid)``."""
    dtype = sum_a.dtype
    mask = stats.in_sample
    maskf = mask.to(dtype)
    big_n = _f(stats.n_total, sum_a)
    n = torch.clamp(stats.n, min=1).to(dtype)
    m = stats.m
    m_safe = torch.clamp(m, min=1).to(dtype)
    big_m = _f(stats.M, sum_a)
    zero = torch.zeros((), dtype=dtype, device=sum_a.device)

    scale = big_m / m_safe
    ahat = torch.where(mask, scale * sum_a, zero)
    bhat = torch.where(mask, scale * sum_b, zero)

    # between-chunk term: N/n · (N-n)/(n-1) · Σ_j (âⱼ - ā)(b̂ⱼ - b̄)
    abar = torch.sum(ahat, dim=-1, keepdim=True) / n[..., None]
    bbar = torch.sum(bhat, dim=-1, keepdim=True) / n[..., None]
    between_ss = torch.sum(maskf * (ahat - abar) * (bhat - bbar), dim=-1)
    n_gt1 = stats.n > 1
    between = torch.where(
        n_gt1,
        big_n / n * (big_n - n) / torch.clamp(n - 1.0, min=1.0) * between_ss,
        torch.full_like(between_ss, float("inf")))
    # a census of the chunk space has no between-chunk variance (n == N == 1
    # falls into the n==1 branch above, so fix it up explicitly)
    census = stats.n == torch.as_tensor(stats.n_total, device=sum_a.device)
    between = torch.where(census, torch.nan_to_num(between, posinf=0.0),
                          between)

    # within-chunk term: N/n · Σ_j (M_j/m_j) (M_j-m_j)/(m_j-1) · SS_j
    ss_within = cross - sum_a * sum_b / m_safe
    fpc = (big_m - m_safe) / torch.clamp(m_safe - 1.0, min=1.0)
    within_j = torch.where(mask, scale * fpc * ss_within, zero)
    # m_j == 1 on a multi-tuple chunk: not estimable; contribute 0, flag it
    singleton = mask & (m == 1) & (stats.M > 1)
    within_j = torch.where(singleton, zero, within_j)
    within = big_n / n * torch.sum(within_j, dim=-1)

    valid = ~torch.any(singleton, dim=-1) & (n_gt1 | census)
    return between + within, valid


def var_hat(stats: BiLevelStats):
    """Eq. (3): unbiased estimator of Var(τ̂) -> ``(variance, valid)``."""
    return _cov_hat(stats, stats.ysum, stats.ysum, cross=stats.ysq)


def count_tau_hat(stats: BiLevelStats) -> torch.Tensor:
    """COUNT is SUM with expression = 1 (Section 4.3): estimate from psum."""
    return tau_hat(stats._replace(ysum=stats.psum))


def count_var_hat(stats: BiLevelStats):
    # pred is 0/1 so Σ p_i^2 = Σ p_i
    return _cov_hat(stats, stats.psum, stats.psum, cross=stats.psum)


def avg_estimate(stats: BiLevelStats):
    """AVERAGE = SUM/COUNT ratio estimator with delta-method variance ->
    ``(estimate, variance, valid)``."""
    tx = tau_hat(stats)
    tp = count_tau_hat(stats)
    var_x, vx_ok = var_hat(stats)
    var_p, vp_ok = count_var_hat(stats)
    cov_xp, cv_ok = _cov_hat(stats, stats.ysum, stats.psum, cross=stats.ysum)
    tp_safe = torch.where(torch.abs(tp) > 0, tp, torch.ones_like(tp))
    r = tx / tp_safe
    var_r = (var_x + r * r * var_p - 2.0 * r * cov_xp) / (tp_safe * tp_safe)
    var_r = torch.clamp(var_r, min=0.0)
    var_r = torch.where(torch.abs(tp) > 0, var_r,
                        torch.full_like(var_r, float("inf")))
    return r, var_r, vx_ok & vp_ok & cv_ok


def z_score(confidence: float, dtype=torch.float32) -> torch.Tensor:
    """z_{(1+c)/2} in ``dtype`` (``torch.special.ndtri``)."""
    return torch.special.ndtri(torch.tensor((1.0 + confidence) / 2.0,
                                            dtype=dtype))


def confidence_bounds(estimate, variance, confidence: float = 0.95):
    """CLT bounds: ``estimate ± z_{(1+c)/2} · sqrt(variance)``."""
    estimate = torch.as_tensor(estimate)
    z = z_score(confidence, estimate.dtype).to(estimate.device)
    half = z * torch.sqrt(torch.clamp(torch.as_tensor(variance), min=0.0))
    return estimate - half, estimate + half


def error_ratio(estimate, lo, hi) -> torch.Tensor:
    """The paper's reported metric: relative CI width (high-low)/|estimate|."""
    estimate = torch.as_tensor(estimate)
    denom = torch.clamp(torch.abs(estimate), min=1e-30)
    return (hi - lo) / denom


# HAVING op codes shared by the string-op and slot-table paths; -1 marks
# "no HAVING clause".
HAVING_NONE = -1
HAVING_OP_CODES = {"<": 0, "<=": 1, ">": 2, ">=": 3}


def having_decision_coded(lo, hi, op, threshold) -> torch.Tensor:
    """Decide ``HAVING agg <op> threshold`` from the confidence interval.

    Returns int8: 1 = decidedly true, 0 = decidedly false, -1 = undecided
    (also -1 wherever ``op == HAVING_NONE``)."""
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi)
    t = torch.as_tensor(threshold, device=lo.device).to(lo.dtype)
    op = torch.as_tensor(op, dtype=torch.int32, device=lo.device)
    true_ = torch.where(op == 0, hi < t,
                        torch.where(op == 1, hi <= t,
                                    torch.where(op == 2, lo > t,
                                                torch.where(op == 3, lo >= t,
                                                            False))))
    false_ = torch.where(op <= 1, lo > t, hi < t)

    def code(v):
        return torch.full((), v, dtype=torch.int8, device=lo.device)

    return torch.where(op == HAVING_NONE, code(-1),
                       torch.where(true_, code(1),
                                   torch.where(false_, code(0), code(-1))))


def having_decision(lo, hi, op: str, threshold) -> torch.Tensor:
    """String-op convenience wrapper over :func:`having_decision_coded`."""
    if op not in HAVING_OP_CODES:
        raise ValueError(f"unsupported HAVING op: {op}")
    return having_decision_coded(lo, hi, HAVING_OP_CODES[op], threshold)


# ---------------------------------------------------------------------------
# Design-time (true) variance, Eq. (2), and the inverse-CLT planning helper
# ---------------------------------------------------------------------------

def variance_true(chunk_sums, within_ss, chunk_sizes, n: int,
                  m) -> torch.Tensor:
    """Eq. (2) for a fixed design (n chunks, m_j tuples from chunk j), in
    the dtype of ``chunk_sums``.

    ``chunk_sums`` are the true y_j, ``within_ss[j] = Σ_{i∈C_j}(x_i −
    y_j/M_j)²``."""
    chunk_sums = torch.as_tensor(chunk_sums)
    big_n = _f(chunk_sums.shape[-1], chunk_sums)
    n = _f(n, chunk_sums)
    big_m = _f(chunk_sizes, chunk_sums)
    m = torch.clamp(_f(m, chunk_sums), min=1.0)
    ybar = torch.mean(chunk_sums, dim=-1, keepdim=True)
    between = big_n / (big_n - 1.0) * (big_n - n) / n * torch.sum(
        (chunk_sums - ybar) ** 2, dim=-1)
    fpc = big_m / torch.clamp(big_m - 1.0, min=1.0) * (big_m - m) / m
    within = big_n / n * torch.sum(fpc * _f(within_ss, chunk_sums), dim=-1)
    return between + within


def sample_size_for_accuracy(estimate, variance, m_used, epsilon,
                             confidence: float = 0.95) -> torch.Tensor:
    """Rough inverse-CLT planning helper: how many more tuples (at the
    current per-tuple variance rate) until ``error_ratio <= epsilon``, in
    the dtype of ``estimate``."""
    estimate = torch.as_tensor(estimate)
    z = z_score(confidence, estimate.dtype).to(estimate.device)
    target_half = torch.abs(estimate) * epsilon / 2.0
    target_var = (target_half / z) ** 2
    variance = _f(variance, estimate)
    ratio = torch.where(target_var > 0,
                        variance / torch.clamp(target_var, min=1e-30),
                        torch.full_like(target_var, float("inf")))
    return torch.ceil(torch.clamp(ratio - 1.0, min=0.0)
                      * torch.clamp(_f(m_used, estimate), min=1.0))
