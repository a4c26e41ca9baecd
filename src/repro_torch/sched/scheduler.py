"""The workload scheduler: SLO admission, fairness and claim ordering
(counterpart of ``repro.sched.scheduler``).

:class:`WorkloadScheduler` is the policy bundle the
:class:`~repro_torch.serve.ola_server.OLAWorkloadServer` consults; it owns
no engine state.  Per decision point:

* **intake** (``queue_key``): ready queries in priority order (weight
  desc, then arrival, then qid) instead of FIFO;
* **admission** (``admission.decide``): admit, queue or shed against the
  query's :class:`~repro_torch.sched.slo.QuerySLO`, the candidate priced by
  the Eq. (4) cost model and the wait by the per-class service-time
  quantile (fed by :meth:`WorkloadScheduler.observe_service`);
* **admission** (``config.preempt``): when a feasible deadline would die
  waiting, evict a strictly-lower-priority slot;
* **per round** (``round_weights``): weighted max-min fairness shares for
  the slot table's ``weight`` column under ``slot_capacity`` contention
  (hand-set, or ``"measured"`` from a calibration via
  :meth:`WorkloadScheduler.calibrate`);
* **per round** (``claim_order``): the variance-guided permutation of the
  schedule's unclaimed tail.

The :data:`NEUTRAL` configuration (infinite capacity, committed claim
order, FIFO queue, no shedding, no enforcement, no preemption) reproduces
the unscheduled server round for round, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np

from repro_torch.sched.admission import AdmissionController
from repro_torch.sched.claims import variance_claim_order
from repro_torch.sched.fairness import FairnessPolicy, measured_slot_capacity
from repro_torch.sched.service_model import ServiceTimeModel
from repro_torch.sched.slo import NO_SLO, PRIORITY_WEIGHTS, QuerySLO


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    # per-round slot-budget units across resident slots (inf: uncontended;
    # 2.0: two full slot evaluations a round, divided by the fairness
    # policy).  "measured" derives it from the calibration's round-cost fit
    # when the server calls WorkloadScheduler.calibrate; without a usable
    # fit it stays inf.
    slot_capacity: Union[float, str] = math.inf
    claim_policy: str = "variance"      # "schedule" (committed) | "variance"
    queue_policy: str = "priority"      # "fifo" | "priority"
    shed_enabled: bool = True
    # return the best estimate at the deadline instead of letting an
    # admitted query overstay its slot
    deadline_enforcement: bool = True
    admission_pessimism: float = 1.0
    # evict a strictly-lower-priority slot when a deadline is feasible only
    # that way; the victim is re-queued with its statistics, never dropped
    preempt: bool = False
    # queue waits are priced at this quantile of each class's observed
    # service times; the full-pass bound is the prior until
    # service_min_samples completions per class
    wait_quantile: float = 0.9
    service_min_samples: int = 8
    # slot_capacity="measured": share of the scan-side round cost that slot
    # evaluation may add (capacity = headroom·base/slot_us)
    measured_headroom: float = 0.5

    def __post_init__(self):
        if self.claim_policy not in ("schedule", "variance"):
            raise ValueError(f"unknown claim_policy {self.claim_policy!r}")
        if self.queue_policy not in ("fifo", "priority"):
            raise ValueError(f"unknown queue_policy {self.queue_policy!r}")
        if (isinstance(self.slot_capacity, str)
                and self.slot_capacity != "measured"):
            raise ValueError(
                f"slot_capacity must be a number or 'measured', got "
                f"{self.slot_capacity!r}")
        if not 0.0 < self.wait_quantile < 1.0:
            raise ValueError(
                f"wait_quantile must be in (0, 1), got {self.wait_quantile}")


#: every scheduling hook engaged, every policy pinned to the unscheduled
#: server's behavior (the parity configuration)
NEUTRAL = SchedulerConfig(slot_capacity=math.inf, claim_policy="schedule",
                          queue_policy="fifo", shed_enabled=False,
                          deadline_enforcement=False, preempt=False)


class WorkloadScheduler:
    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        cap = (math.inf if config.slot_capacity == "measured"
               else config.slot_capacity)
        self.fairness = FairnessPolicy(cap)
        self.service_model = ServiceTimeModel(
            quantile=config.wait_quantile,
            min_samples=config.service_min_samples)
        self.admission = AdmissionController(
            shed_enabled=config.shed_enabled,
            pessimism=config.admission_pessimism,
            service_model=self.service_model)

    # -------------------------------------------------------- calibration ----
    def calibrate(self, rates) -> None:
        """Bind a :class:`~repro_torch.serve.ola_server.MeasuredRates`
        calibration: with ``slot_capacity="measured"`` the fairness capacity
        follows its round-cost fit (``inf`` without one).  Hand-set numeric
        capacities are never overridden.  Idempotent, host-side."""
        if self.config.slot_capacity != "measured":
            return
        cap = measured_slot_capacity(rates, self.config.measured_headroom)
        self.fairness.slot_capacity = math.inf if cap is None else cap

    def bind_metrics(self, registry) -> None:
        """Expose the admission decision tallies and the fairness slot
        capacity on a :class:`~repro_torch.obs.metrics.MetricsRegistry`."""
        self.admission.bind_metrics(registry)
        registry.gauge("sched_slot_capacity",
                       help="fairness slot capacity (per-round budget units)",
                       fn=lambda: self.fairness.slot_capacity)

    # ------------------------------------------------------------ feedback ----
    def observe_service(self, slo: Optional[QuerySLO],
                        service_s: float) -> None:
        """Feed one completed query's scan service time (slot grant to
        retirement, modeled seconds) into its class's quantile sketch."""
        self.service_model.observe((slo or NO_SLO).priority, float(service_s))

    # ------------------------------------------------------------- intake ----
    def queue_key(self, wq) -> tuple:
        """Sort key for the ready queue (ascending)."""
        if self.config.queue_policy == "fifo":
            return (wq.arrival_t, wq.qid)
        slo = wq.slo or NO_SLO
        return (-PRIORITY_WEIGHTS[slo.priority], wq.arrival_t, wq.qid)

    # ---------------------------------------------------------- per round ----
    def round_weights(self, slot_slos: list, active: np.ndarray) -> np.ndarray:
        """Fairness shares (S,) float32 for the slot table's weight column;
        ``slot_slos[s]`` is the resident query's SLO (or None)."""
        prio = np.asarray([
            PRIORITY_WEIGHTS[(slo or NO_SLO).priority] for slo in slot_slos],
            np.float64)
        return self.fairness.weights(prio, active).astype(np.float32)

    def claim_order(self, state, chunk_sizes: np.ndarray,
                    active: Optional[np.ndarray] = None,
                    slot_need: Optional[np.ndarray] = None,
                    ) -> Optional[np.ndarray]:
        """The variance-guided claim permutation (``None`` under
        ``claim_policy="schedule"`` or when the order stands)."""
        if self.config.claim_policy != "variance":
            return None
        return variance_claim_order(state, chunk_sizes, active,
                                    slot_need=slot_need)

    # ---------------------------------------------------------------- SLO ----
    @staticmethod
    def effective_epsilon(query, slo: Optional[QuerySLO],
                          seed_estimate: Optional[float]) -> float:
        """Translate an absolute half-width target into the engine's
        relative ε using the seed's magnitude estimate; without one the
        query's own ε stands (the absolute target is then checked only at
        completion, by :meth:`QuerySLO.met`)."""
        eps = float(query.epsilon)
        if slo is None or not math.isfinite(slo.target_halfwidth):
            return eps
        if seed_estimate is None or not math.isfinite(seed_estimate) \
                or abs(seed_estimate) < 1e-12:
            return eps
        # err ratio = (hi-lo)/(2|est|) = halfwidth/|est|
        return float(min(eps, slo.target_halfwidth / abs(seed_estimate)))
