"""The end-to-end arithmetic: latencies, percentiles and the answer rate.

A run's latency sample is every query answered in the window and every
query in flight when the window closed.  The latter count with the
latency they end up with (the run waits for them after the close, up to
the traffic's ``drain_s``); one that never came counts at its age when the
wait ended, a lower bound, so a stall still shows in the tail.
"""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    closest ranks (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_latencies(answers, t_open: float, t_close: float,
                     t_end: float) -> list[float]:
    """Latency of each query answered in ``(t_open, t_close]`` or in flight
    at ``t_close``; a query in flight that was never answered counts at its
    age at ``t_end``."""
    out = []
    for a in answers:
        if a.t_submit > t_close:
            continue
        if a.t_answer is None:
            out.append(t_end - a.t_submit)
        elif a.t_answer > t_open:
            out.append(a.t_answer - a.t_submit)
    return out


def answers_in(answers, t_open: float, t_close: float) -> int:
    return sum(1 for a in answers
               if a.t_answer is not None and t_open < a.t_answer <= t_close)


def end_to_end(answers, t_open: float, t_close: float, t_end: float) -> dict:
    lat = window_latencies(answers, t_open, t_close, t_end)
    return dict(
        answers_per_s=answers_in(answers, t_open, t_close)
        / (t_close - t_open),
        answer_p50_s=percentile(lat, 50.0),
        answer_p95_s=percentile(lat, 95.0),
        latency_samples=len(lat))
