"""SLO-feasibility admission control and Eq. (4) scan pricing for the
workload server (counterpart of ``repro.sched.admission``).

The :class:`AdmissionController` triages each ready query from the same
Eq. (4) cost terms ``select_plan`` uses (measured rates when a calibration
exists, modeled constants otherwise):

* **tier-1** — a promoted rollup cell (:mod:`repro_torch.serve.rollup`)
  already answers the query within its accuracy target: zero scan seconds
  beats every plan below;
* **admit** — a slot is free and the predicted finish lands inside the
  deadline;
* **queue** — no slot now (or higher-priority work is ahead) but the
  deadline is still reachable once one frees;
* **shed** — the deadline is hopeless even under the prediction; the
  server answers at once from the synopsis, flagged best-effort.

The candidate's own service prediction is a coarse CLT extrapolation
``err ∝ 1/√m`` from its seed (a full pass without one).  The wait is priced
per job ahead (resident slots and queued work) at its class's observed
service-time quantile (:class:`~repro_torch.sched.service_model
.ServiceTimeModel`), the full-pass bound as the cold-start prior.  Queries
without a deadline are never shed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

ADMIT, QUEUE, SHED = "admitted", "queued", "shed"
#: answered from the rollup cache: no slot, no scan rounds (decided before
#: the admit/queue/shed triage)
TIER1 = "tier1"


def eq4_cost_terms(store, config, rates=None, *, total_bytes=None,
                   total_tuples=None, decoded_fraction: float = 0.0) -> tuple:
    """The two Eq. (4) cost terms for one full pass over ``store`` —
    ``(T_io, T_cpu)`` modeled seconds — on measured rates when available
    (worker-count and codec-cost rescaled), modeled constants otherwise.

    ``total_bytes``/``total_tuples`` override the store totals (the server
    prices a surviving population after chunk quarantine);
    ``decoded_fraction`` discounts the CPU term by the share of tuples a
    decoded-chunk cache holds."""
    if total_bytes is None:
        total_bytes = float(store.chunk_sizes.sum()) * store.codec.record_bytes
    if total_tuples is None:
        total_tuples = float(store.num_tuples)
    total_bytes, total_tuples = float(total_bytes), float(total_tuples)
    if rates is not None:
        t_io = total_bytes / rates.io_bytes_per_sec
        # the measured tuple rate is aggregate over the calibration run's
        # worker count; extraction scales with workers, reads do not
        cpu_rate = rates.cpu_tuples_per_sec * config.num_workers / rates.workers
        # tuples/s is codec-relative: rescale by the extraction-cost ratio
        if rates.cost_per_tuple > 0:
            cpu_rate *= (rates.cost_per_tuple
                         / max(store.codec.extract_cost_per_tuple(), 1e-12))
        t_cpu = total_tuples / cpu_rate
    else:
        t_io = total_bytes / config.io_bytes_per_sec
        t_cpu = (total_tuples * store.codec.extract_cost_per_tuple()
                 / config.cpu_tuple_ops_per_sec / config.num_workers)
    t_cpu *= 1.0 - min(max(float(decoded_fraction), 0.0), 1.0)
    return t_io, t_cpu


def scan_tuples_per_s(store, config, rates=None, *, total_bytes=None,
                      total_tuples=None, decoded_fraction: float = 0.0
                      ) -> float:
    """Aggregate scan throughput (tuples per modeled second) for a full
    pass: the Eq. (4) overlapped-pipeline rate ``total / max(T_io, T_cpu)``."""
    t_io, t_cpu = eq4_cost_terms(store, config, rates,
                                 total_bytes=total_bytes,
                                 total_tuples=total_tuples,
                                 decoded_fraction=decoded_fraction)
    n = float(store.num_tuples) if total_tuples is None else float(total_tuples)
    return n / max(t_io, t_cpu, 1e-12)


@dataclasses.dataclass(frozen=True)
class ServerLoad:
    """Snapshot of the server at one admission attempt.

    ``slot_drain_s`` / ``queue_ahead_service_s`` are the service-model-
    priced wait components (seconds until a slot frees, and the summed
    predicted service of queued work ahead); ``None`` makes
    :meth:`AdmissionController.decide` fall back to a per-job estimate."""

    now: float                      # modeled server clock
    free_slots: int
    queue_ahead: int                # higher-priority/earlier queries waiting
    scan_rate: float                # tuples per modeled second
    total_tuples: int
    mean_service_s: Optional[float] = None   # completed-query history
    slot_drain_s: Optional[float] = None     # model-priced occupant drain
    queue_ahead_service_s: Optional[float] = None  # model-priced queue work


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    action: str                     # ADMIT | QUEUE | SHED | TIER1
    predicted_service_s: float
    predicted_finish_t: float       # modeled-clock completion estimate
    reason: str

    def as_dict(self) -> dict:
        """JSON-able form (explain records, metrics snapshots)."""
        return dataclasses.asdict(self)


class AdmissionController:
    """Feasibility triage (see the module docstring).

    ``pessimism`` scales the service prediction (>1 sheds earlier);
    ``shed_enabled=False`` turns every would-be shed into a queue;
    ``service_model`` prices per-job waits at the class quantile (without
    one: the observed mean, and with no history the full-pass bound)."""

    def __init__(self, shed_enabled: bool = True, pessimism: float = 1.0,
                 service_model=None):
        self.shed_enabled = bool(shed_enabled)
        self.pessimism = float(pessimism)
        self.service_model = service_model
        self.decisions: dict[str, int] = {
            ADMIT: 0, QUEUE: 0, SHED: 0, TIER1: 0}

    def _done(self, d: AdmissionDecision) -> AdmissionDecision:
        self.decisions[d.action] = self.decisions.get(d.action, 0) + 1
        return d

    def bind_metrics(self, registry, prefix: str = "admission") -> None:
        """Expose the per-action decision tallies as pull gauges."""
        for action in (ADMIT, QUEUE, SHED, TIER1):
            registry.gauge(f"{prefix}_decisions",
                           help="admission decisions by action",
                           labels={"action": action},
                           fn=(lambda a=action: self.decisions.get(a, 0)))

    @staticmethod
    def required_tuples(seed_m: int, seed_err: float, epsilon: float,
                        total_tuples: int) -> float:
        """Additional sample the query still needs, by CLT extrapolation:
        from ``(m₀, err₀)`` hitting ε takes ``m₀·(err₀/ε)²`` tuples in all.
        With no usable seed the bound is a full pass."""
        if (seed_m > 0 and math.isfinite(seed_err) and seed_err > 0
                and epsilon > 0):
            if seed_err <= epsilon:
                return 0.0
            m_target = seed_m * (seed_err / epsilon) ** 2
            return float(min(total_tuples, m_target) - seed_m)
        return float(total_tuples)

    def decide(self, *, arrival_t: float, slo, epsilon: float,
               load: ServerLoad, seed_m: int = 0,
               seed_err: float = math.inf,
               rollup_err: float = math.inf,
               group_count: int = 0) -> AdmissionDecision:
        """One admission call.  ``seed_m``/``seed_err`` describe the best
        seeded answer available now (0/inf: none).  ``group_count > 0``
        marks a grouped query whose cells converge independently: the CLT
        need multiplies by the cell count, capped at one full pass.
        ``rollup_err`` is the Tier-1 answer's error ratio (``inf``: no
        promoted cell; 0.0 when its HAVING verdict is decided): when it
        meets ε the query is answered Tier-1 before the triage."""
        if rollup_err <= epsilon:
            return self._done(AdmissionDecision(
                TIER1, 0.0, max(load.now, arrival_t),
                f"rollup answer meets target (err {rollup_err:.3g} <= "
                f"eps {epsilon:.3g}) at zero scan cost"))
        free = load.free_slots > 0 and load.queue_ahead == 0
        need = self.required_tuples(seed_m, seed_err, epsilon,
                                    load.total_tuples)
        if group_count > 0:
            need = min(float(load.total_tuples), need * group_count)
        service = self.pessimism * need / max(load.scan_rate, 1e-12)
        if free:
            wait = 0.0
        else:
            # wait for a slot to drain, then for every queued job ahead,
            # each priced by the service model when the caller priced it;
            # the per-job fallback is the observed mean, and with no
            # history the full-pass bound (never the candidate's own
            # seed-discounted service)
            full_pass = load.total_tuples / max(load.scan_rate, 1e-12)
            per = load.mean_service_s if load.mean_service_s else full_pass
            if self.service_model is not None:
                per = self.service_model.predict(slo.priority, per)
            drain = load.slot_drain_s if load.slot_drain_s is not None else per
            ahead = (load.queue_ahead_service_s
                     if load.queue_ahead_service_s is not None
                     else load.queue_ahead * per)
            wait = drain + ahead
        finish = max(load.now, arrival_t) + wait + service

        if not slo.has_deadline:
            action = ADMIT if free else QUEUE
            return self._done(
                AdmissionDecision(action, service, finish, "no deadline"))
        deadline_t = arrival_t + slo.deadline_s
        if finish > deadline_t and self.shed_enabled:
            return self._done(AdmissionDecision(
                SHED, service, finish,
                f"predicted finish {finish:.3g}s past deadline "
                f"{deadline_t:.3g}s"))
        action = ADMIT if free else QUEUE
        return self._done(
            AdmissionDecision(action, service, finish, "deadline feasible"))
