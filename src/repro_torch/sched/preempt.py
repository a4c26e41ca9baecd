"""Deadline-feasibility preemption: evict a lower-priority slot for a hot
deadline (counterpart of ``repro.sched.preempt``).

:func:`select_victim` is the policy half: given the candidate's SLO and
the resident slots' SLOs, pick the slot to evict, or ``None`` when
preemption cannot help.  The mechanism half is the server's
``OLAWorkloadServer._evict``: the victim's statistics row is snapshotted
on the host (:func:`repro_torch.core.engine.slot_stats_snapshot`), the
slot is released, and the victim re-enters the queue flagged
``preempted``; on re-admission the snapshot seeds its slot, so no sample is
lost and the query is never dropped.  The server preempts only when
waiting is infeasible (the predicted finish lands past the deadline) and
preempting is sufficient (admitted now, the predicted service fits).
Guarded by ``SchedulerConfig.preempt`` (default off).
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.sched.slo import NO_SLO, PRIORITY_WEIGHTS


def select_victim(candidate_slo, slot_slos: Sequence,
                  slot_admit_t: Sequence[float],
                  evictable: Sequence[bool]) -> Optional[int]:
    """Pick the slot to evict for ``candidate_slo``, or ``None``.

    ``slot_slos[s]`` is the resident query's SLO (``None`` for empty or
    no-SLO slots, read as :data:`~repro_torch.sched.slo.NO_SLO`);
    ``evictable[s]`` gates the slots that may be taken at all.  Only slots
    of **strictly lower** priority weight qualify: equal-priority work is
    never preempted.  Among them the victim has the lowest weight, ties
    broken by the *latest* admission (the least sunk scan work).
    """
    cand_w = (candidate_slo or NO_SLO).weight
    best: Optional[int] = None
    best_key = None
    for s, (slo, ok) in enumerate(zip(slot_slos, evictable)):
        if not ok:
            continue
        w = PRIORITY_WEIGHTS[(slo or NO_SLO).priority]
        if w >= cand_w:
            continue
        key = (w, -float(slot_admit_t[s]))
        if best_key is None or key < best_key:
            best, best_key = s, key
    return best
