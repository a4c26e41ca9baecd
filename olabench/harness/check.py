"""Whether the answers the timed path delivered are correct.

Every answer of the run is judged against the reference's exact value of
its query, by what it says: an estimate with a confidence interval [lo,
hi] at the configuration's confidence, whose relative width (hi - lo) /
|estimate| the server held to the query's epsilon.  Three numbers are
compared, each with its limit from the configuration's ``check`` group:

* ``unanswered``: queries submitted in the run that never got an answer,
  even after the wait past the window's close, or whose answer has no
  finite estimate and interval (limit 0);
* ``over_eps``: answers whose relative width (hi - lo) / |estimate|,
  worked out here from the three numbers the answer gives, exceeds their
  query's epsilon, which the server promises never to deliver (limit 0;
  the slack is the rounding of lo and hi to float32 as delivered);
* ``off_4hw_pct``: the share of answers whose exact value lies more than
  four of their own half-widths from the estimate (limit from readings of
  sound runs and of the control; see PERF.md).  The answers of one run
  share one sample, so their errors are correlated and a share of the
  interval's nominal misses swings from seed to seed; four half-widths is
  where sound runs read a few percent at most while intervals that are
  too narrow by a few times read tens of percent.
"""

from __future__ import annotations

import math

import numpy as np

#: float32's relative rounding step (2**-23): lo, hi and the estimate are
#: delivered as float32
F32_ULP = 2.0 ** -23


def judge(answers: list[dict], exact: list[float], outstanding: int,
          limits: dict) -> dict:
    """``answers``: each ``{spec, estimate, lo, hi, epsilon, unserved}``;
    ``exact``: the reference's value by spec; ``outstanding``:
    queries never answered.  Returns ``{name: {value, limit}}`` and
    ``correct``."""
    bad = outstanding
    over = 0
    off = 0
    judged = 0
    for a in answers:
        if a["unserved"] or not all(math.isfinite(a[k]) for k in
                                    ("estimate", "lo", "hi")):
            bad += 1
            continue
        judged += 1
        eps32 = float(np.float32(a["epsilon"]))
        width = a["hi"] - a["lo"]
        rounding = (abs(a["hi"]) + abs(a["lo"])) * F32_ULP
        if width - rounding > eps32 * abs(a["estimate"]) * (1 + F32_ULP):
            over += 1
        half = (a["hi"] - a["lo"]) / 2.0
        if abs(a["estimate"] - exact[a["spec"]]) > 4.0 * half:
            off += 1
    numbers = {
        "unanswered": {"value": bad, "limit": int(limits["unanswered"])},
        "over_eps": {"value": over, "limit": int(limits["over_eps"])},
        "off_4hw_pct": {"value": 100.0 * off / max(judged, 1),
                        "limit": float(limits["off_4hw_pct"])},
    }
    correct = judged > 0 and all(n["value"] <= n["limit"]
                                 for n in numbers.values())
    return dict(numbers=numbers, correct=correct, judged=judged)
