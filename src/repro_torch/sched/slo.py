"""Service-level objectives for workload queries (counterpart of
``repro.sched.slo``).

A :class:`QuerySLO` rides along with a submitted query and tells the
scheduler (:mod:`repro_torch.sched.scheduler`) what good service means for
it:

* ``deadline_s`` — modeled seconds *from arrival* by which the answer must
  be returned.  Admission checks feasibility against it, the fairness
  policy prioritizes against it, and (with enforcement on) the server
  returns the best estimate available at the deadline instead of letting
  the query overstay: OLA trades accuracy for time, per query.
* ``target_halfwidth`` — absolute confidence-interval half-width target.
  The engine's native stop condition is the *relative* error ratio ε; when
  a synopsis seed gives a magnitude estimate, the scheduler translates the
  absolute target into an effective ε for the slot row.
* ``priority`` — class label mapped to a weight by
  :data:`PRIORITY_WEIGHTS`; drives queue order and the weighted max-min
  fairness split.
"""

from __future__ import annotations

import dataclasses
import math

# Priority class → fairness weight.  Ratios, not absolutes: an interactive
# slot gets 4× a batch slot's share when the round budget is contended.
PRIORITY_WEIGHTS = {
    "batch": 1.0,
    "normal": 2.0,
    "interactive": 4.0,
}


@dataclasses.dataclass(frozen=True)
class QuerySLO:
    """Per-query service-level objective (all fields optional).

    The default instance — infinite deadline, no half-width target, normal
    priority — is the no-SLO query: the scheduler admits or FIFO-queues it
    and never sheds it.
    """

    deadline_s: float = math.inf        # modeled seconds from arrival
    target_halfwidth: float = math.inf  # absolute CI half-width target
    priority: str = "normal"

    def __post_init__(self):
        if self.priority not in PRIORITY_WEIGHTS:
            raise ValueError(
                f"unknown priority {self.priority!r}; expected one of "
                f"{sorted(PRIORITY_WEIGHTS)}")
        if not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s}")
        if not self.target_halfwidth > 0:
            raise ValueError(
                f"target_halfwidth must be positive, got "
                f"{self.target_halfwidth}")

    @property
    def weight(self) -> float:
        return PRIORITY_WEIGHTS[self.priority]

    @property
    def has_deadline(self) -> bool:
        return math.isfinite(self.deadline_s)

    def met(self, latency_s: float, halfwidth: float) -> bool:
        """Did a completed query hit this SLO?  A NaN half-width (an
        unserved query: no answer at all) never counts as a hit, even for
        a deadline-only SLO."""
        if math.isnan(halfwidth):
            return False
        if latency_s > self.deadline_s:
            return False
        if math.isfinite(self.target_halfwidth):
            return bool(halfwidth <= self.target_halfwidth)
        return True


NO_SLO = QuerySLO()
