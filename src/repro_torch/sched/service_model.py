"""Online per-priority-class service-time distributions (counterpart of
``repro.sched.service_model``).

Service times under OLA are heavy-tailed: a loose-ε interactive probe
retires in one round, a tight-ε batch sum rides the scan to near-census.
A deadline decision priced at the mean is optimistic exactly when the
queue is full of the slow kind, so the admission controller prices each
queued or resident job at its priority class's p-quantile (default p90,
``SchedulerConfig.wait_quantile``) from :class:`ServiceTimeModel`: one
running quantile sketch per class, fed a ``(priority, service_seconds)``
pair at every retirement.

The sketch is Jain & Chlamtac's P² algorithm: five markers per class,
O(1) memory and update, no sample buffer.  Below ``min_samples``
observations the prediction blends the sketch with the caller's prior (the
Eq. (4) full-pass bound), sliding from model-free to measured as evidence
accumulates.
"""

from __future__ import annotations

import math
from typing import Optional


class P2Quantile:
    """Jain & Chlamtac's P² streaming quantile estimator (one quantile).

    Constant memory: five marker heights and positions.  Until five
    observations arrive the estimate is the exact empirical quantile of the
    buffered prefix.
    """

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {p}")
        self.p = float(p)
        self.n_obs = 0
        self._q: list[float] = []        # marker heights
        self._n: list[float] = []        # marker positions (1-indexed)
        self._dn = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def observe(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            return                       # a NaN/inf service time is a bug
        self.n_obs += 1
        if self.n_obs <= 5:
            self._q.append(x)
            self._q.sort()
            if self.n_obs == 5:
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
            return
        q, n = self._q, self._n
        # locate the cell and clamp the extremes
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (q[k] <= x < q[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        # desired positions drift by the quantile increments
        nd = [1.0 + (self.n_obs - 1) * d for d in self._dn]
        for i in (1, 2, 3):
            d = nd[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (
                    d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = math.copysign(1.0, d)
                # parabolic (P²) adjustment, linear fallback when it would
                # push the marker out of order
                qp = q[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (q[i + 1] - q[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1])
                    / (n[i] - n[i - 1]))
                if not (q[i - 1] < qp < q[i + 1]):
                    j = i + int(d)
                    qp = q[i] + d * (q[j] - q[i]) / (n[j] - n[i])
                q[i] = qp
                n[i] += d

    def value(self) -> Optional[float]:
        """Current quantile estimate; ``None`` before any observation."""
        if self.n_obs == 0:
            return None
        if self.n_obs <= 5:
            # at five or fewer observations _q is still the raw sorted
            # sample: interpolate (a p90 over [1,1,1,1,100] is ~60, not 1)
            k = self.p * (len(self._q) - 1)
            lo = int(math.floor(k))
            hi = min(lo + 1, len(self._q) - 1)
            return self._q[lo] + (k - lo) * (self._q[hi] - self._q[lo])
        return self._q[2]


class ServiceTimeModel:
    """Per-priority-class service-time quantiles, fitted online.

    ``observe(priority, service_s)`` feeds one completed query;
    ``predict(priority, prior_s)`` returns the class's ``quantile``
    estimate once ``min_samples`` observations exist, a linear blend of
    sketch and ``prior_s`` below that, and ``prior_s`` itself with no
    evidence.  A class never observed stays on the prior.
    """

    def __init__(self, quantile: float = 0.9, min_samples: int = 8):
        if not min_samples >= 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        self.quantile = float(quantile)
        self.min_samples = int(min_samples)
        self._sketch: dict[str, P2Quantile] = {}

    def observe(self, priority: str, service_s: float) -> None:
        if not (math.isfinite(service_s) and service_s >= 0.0):
            return
        sk = self._sketch.get(priority)
        if sk is None:
            sk = self._sketch[priority] = P2Quantile(self.quantile)
        sk.observe(service_s)

    def n_obs(self, priority: str) -> int:
        sk = self._sketch.get(priority)
        return 0 if sk is None else sk.n_obs

    def predict(self, priority: str, prior_s: float) -> float:
        """Quantile of the class's observed service times, cold-started
        from ``prior_s``: with ``n`` observations the result is
        ``(n·sketch + (min_samples - n)·prior) / min_samples`` until
        ``n >= min_samples``, then the sketch alone."""
        sk = self._sketch.get(priority)
        est = None if sk is None else sk.value()
        if est is None:
            return float(prior_s)
        n = sk.n_obs
        if n >= self.min_samples:
            return float(est)
        w = n / float(self.min_samples)
        return float(w * est + (1.0 - w) * prior_s)
