"""SLO-aware workload scheduling: admission, fairness, preemption and
claim ordering (counterpart of ``repro.sched``).

:class:`QuerySLO` describes what a query needs; :class:`AdmissionController`
triages admit/queue/shed, the candidate priced by the Eq. (4) cost model
and the wait by the learned per-class service-time quantile
(:class:`ServiceTimeModel`); :class:`FairnessPolicy` divides each round's
evaluation budget across resident slots by weighted max-min (capacity
hand-set or from a calibration, :func:`measured_slot_capacity`);
:func:`select_victim` picks the slot to evict when a feasible deadline
would otherwise die in the queue; :func:`variance_claim_order` reorders the
scan's unclaimed chunk tail.  :class:`WorkloadScheduler` bundles them; the
:data:`NEUTRAL` configuration reproduces the unscheduled server bit for
bit.
"""

from repro_torch.sched.admission import (
    ADMIT,
    QUEUE,
    SHED,
    TIER1,
    AdmissionController,
    AdmissionDecision,
    ServerLoad,
    scan_tuples_per_s,
)
from repro_torch.sched.claims import slot_chunk_variances, variance_claim_order
from repro_torch.sched.fairness import (
    FairnessPolicy,
    max_min_weights,
    measured_slot_capacity,
)
from repro_torch.sched.preempt import select_victim
from repro_torch.sched.scheduler import (
    NEUTRAL,
    SchedulerConfig,
    WorkloadScheduler,
)
from repro_torch.sched.service_model import P2Quantile, ServiceTimeModel
from repro_torch.sched.slo import NO_SLO, PRIORITY_WEIGHTS, QuerySLO

__all__ = [
    "ADMIT", "QUEUE", "SHED", "TIER1",
    "AdmissionController", "AdmissionDecision", "ServerLoad",
    "scan_tuples_per_s", "slot_chunk_variances", "variance_claim_order",
    "FairnessPolicy", "max_min_weights", "measured_slot_capacity",
    "select_victim",
    "P2Quantile", "ServiceTimeModel",
    "NEUTRAL", "SchedulerConfig", "WorkloadScheduler",
    "NO_SLO", "PRIORITY_WEIGHTS", "QuerySLO",
]
