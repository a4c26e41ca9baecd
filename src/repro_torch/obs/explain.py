"""Per-query explain records: "why did my query do that", in one structure.

Every :class:`~repro_torch.serve.ola_server.WorkloadResult` carries an
:class:`ExplainRecord` assembled over the query's lifecycle:

* **admission** — the Eq. (4) full-pass cost terms the triage priced the
  scan with (``cost_t_io_s`` / ``cost_t_cpu_s``, decoded-cache discount
  included), the plan the selector chose, and the scheduler's decision
  with its reason string (``admitted`` / ``queued`` / ``shed`` /
  ``tier1``) and service/finish predictions;
* **tier routing** — which tier answered (``scan``, ``tier1`` rollup
  cell, ``synopsis`` seed, ``shed`` best-effort) and why;
* **trajectory** — one :class:`RoundSample` per resident round: the
  slot's cumulative sample size ``m``, running estimate, CI half-width,
  the round's effective per-worker budget ``b_eff`` (the budget-ladder
  value scaled by the slot's fairness weight) and the weight itself —
  the estimate/CI convergence curve the OLA literature treats as the
  primary UX artifact.  The buffer is bounded: past ``max_samples`` the
  trajectory thins itself to every 2nd (4th, 8th, ...) round, keeping
  endpoints, so a census-length residency cannot grow a result without
  bound;
* **degradation** — quarantine events that struck while the query was
  resident (the population its final answer describes shrank);
* **final answer** — ``final_estimate`` / ``final_ci_halfwidth``, set at
  retirement from the *same floats* the result reports: bit-for-bit
  equal to ``result.estimate`` / ``result.halfwidth`` by construction.

Everything here is host-side bookkeeping over values the server already
holds; nothing reaches back into the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RoundSample:
    """One resident round of one query's convergence trajectory."""

    round: int              # server round index (global, monotone)
    m: int                  # cumulative slot sample size (tuples)
    est: float              # running estimate
    ci_halfwidth: float     # (hi - lo) / 2 at this round
    b_eff: int              # effective per-worker budget this round
    weight: float           # fairness weight applied this round
    # grouped queries only: per-cell ``(value, est, ci_halfwidth)`` triples —
    # tracked cells in discovery order, then the ``__other__`` spill cell
    # (value NaN).  Plain floats, so the record stays serializable and this
    # module stays free of engine imports.  None for ungrouped rounds.
    groups: Optional[tuple] = None


@dataclasses.dataclass
class ExplainRecord:
    """Lifecycle explain for one query (see module docstring)."""

    qid: int
    name: str
    t_submit: float
    # --- admission ---
    plan: str = ""
    sched_outcome: str = ""
    admission_reason: str = ""
    predicted_service_s: Optional[float] = None
    predicted_finish_t: Optional[float] = None
    cost_t_io_s: Optional[float] = None      # Eq. (4) full-pass READ seconds
    cost_t_cpu_s: Optional[float] = None     # Eq. (4) full-pass EXTRACT seconds
    decoded_fraction: float = 0.0            # CPU-discount input at admission
    effective_epsilon: Optional[float] = None
    # --- tier routing ---
    tier: str = ""                           # scan | tier1 | synopsis | shed
    tier_reason: str = ""
    seeded_tuples: int = 0
    # --- trajectory / degradation ---
    trajectory: list = dataclasses.field(default_factory=list)
    degradation: list = dataclasses.field(default_factory=list)
    # --- timing + final answer (set at retirement) ---
    t_admit: Optional[float] = None
    t_done: Optional[float] = None
    rounds_resident: int = 0
    final_estimate: Optional[float] = None
    final_ci_halfwidth: Optional[float] = None

    #: Trajectory length bound; beyond it the record thins to every
    #: 2nd/4th/... round (class-level knob, deliberately not per-instance).
    max_samples = 4096

    _stride: int = dataclasses.field(default=1, repr=False)
    _seen: int = dataclasses.field(default=0, repr=False)

    # -------------------------------------------------------- lifecycle ----
    def record_round(self, sample: RoundSample) -> None:
        """Append one resident round, thinning past ``max_samples``."""
        self._seen += 1
        if (self._seen - 1) % self._stride:
            return
        self.trajectory.append(sample)
        if len(self.trajectory) >= self.max_samples:
            self.trajectory = self.trajectory[::2]
            self._stride *= 2

    def record_degradation(self, *, round: int, t: float,
                           chunk_ids: list) -> None:
        self.degradation.append({
            "round": int(round), "t": float(t),
            "chunk_ids": [int(j) for j in chunk_ids]})

    def finalize(self, result) -> "ExplainRecord":
        """Stamp retirement facts from the completed
        :class:`~repro_torch.serve.ola_server.WorkloadResult` — the final
        estimate/CI are copied from the result's own floats, so equality
        is bit-for-bit by construction."""
        self.plan = result.plan
        self.sched_outcome = result.sched_outcome
        self.t_admit = result.t_admit
        self.t_done = result.t_done
        self.rounds_resident = result.rounds_resident
        self.seeded_tuples = result.seeded_tuples
        self.final_estimate = result.estimate
        self.final_ci_halfwidth = result.halfwidth
        if not self.tier:
            self.tier = ("tier1" if result.sched_outcome == "tier1" else
                         "shed" if result.sched_outcome == "shed" else
                         "synopsis" if result.from_synopsis else "scan")
        return self

    # ----------------------------------------------------------- export ----
    def to_dict(self) -> dict:
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)
               if not f.name.startswith("_")}
        out["trajectory"] = [dataclasses.asdict(s) for s in self.trajectory]
        return out
