"""Weighted max-min fairness over per-slot round budgets (counterpart of
``repro.sched.fairness``).

Each engine round extracts up to ``b_eff`` tuples per worker, and every
active slot may *count* up to the full window: one budget unit per slot.
When the deployment caps the per-round evaluation work at
``slot_capacity`` units, the round budget is divided.
:func:`max_min_weights` is weighted water-filling: every active slot
demands 1.0 unit; shares grow with the slots' priority weights until a
slot's demand is met (share capped at 1.0), and the freed capacity goes to
the rest.

* no contention (``capacity >= active``): every share is exactly 1.0, so
  the round is bit for bit the unscheduled server's;
* equal weights under contention: equal shares ``capacity / active``;
* a slot never gets more than 1.0 or, under contention, less than its
  weight-proportional floor.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def max_min_weights(priority: np.ndarray, active: np.ndarray,
                    capacity: float) -> np.ndarray:
    """Per-slot fairness shares in ``(0, 1]``.

    ``priority (S,)`` positive weights, ``active (S,)`` bool, ``capacity``
    total units across active slots (``inf``: uncontended).  Inactive slots
    get 1.0 (the slot table gates them out of the round anyway).
    """
    priority = np.asarray(priority, np.float64)
    active = np.asarray(active, bool)
    out = np.ones(priority.shape[0], np.float64)
    idx = np.flatnonzero(active)
    n_act = len(idx)
    if n_act == 0 or capacity >= n_act:
        return out
    if not np.all(priority[idx] > 0):
        raise ValueError("priority weights must be positive")
    cap = max(float(capacity), 1e-9)
    w = priority[idx].copy()
    share = np.zeros(n_act, np.float64)
    remaining = np.ones(n_act, bool)
    # water-fill: raise the level λ until Σ min(1, λ·w_i) == capacity; each
    # pass saturates at least one slot or solves the linear remainder
    while cap > 1e-12 and remaining.any():
        w_rem = w[remaining]
        lam = cap / w_rem.sum()
        grant = lam * w_rem
        if np.all(grant <= 1.0 + 1e-12):
            share[remaining] += np.minimum(grant, 1.0)
            break
        sat = np.zeros(n_act, bool)
        sat[np.flatnonzero(remaining)[grant > 1.0]] = True
        share[sat] = 1.0
        cap -= float(sat.sum())
        remaining &= ~sat
    out[idx] = np.clip(share, 1e-6, 1.0)  # every active slot makes progress
    return out


def measured_slot_capacity(rates, headroom: float = 0.5) -> Optional[float]:
    """Per-round slot-budget units from a calibration's round-cost fit
    ``round_us(S) = base + slot_us·S`` (``MeasuredRates.round_base_us`` and
    ``round_slot_us``): ``capacity = headroom · base / slot_us``, the slot
    evaluation that fits in a ``headroom`` share of the scan-side round
    cost, floored at 1.0 (a lone slot always gets the full window).
    ``None`` (the caller keeps its static knob) when the calibration has no
    fit or a degenerate one."""
    if rates is None:
        return None
    base = float(getattr(rates, "round_base_us", 0.0) or 0.0)
    slot = float(getattr(rates, "round_slot_us", 0.0) or 0.0)
    if not (math.isfinite(base) and math.isfinite(slot)
            and base > 0.0 and slot > 0.0):
        return None
    if not headroom > 0:
        raise ValueError(f"headroom must be positive: {headroom}")
    return max(1.0, headroom * base / slot)


class FairnessPolicy:
    """The capacity knob with the water-filling rule.  ``slot_capacity``
    may be retargeted after construction (the scheduler's ``calibrate``
    swaps in the measured capacity); weights are computed fresh from the
    current value every round."""

    def __init__(self, slot_capacity: float = math.inf):
        if not slot_capacity > 0:
            raise ValueError(
                f"slot_capacity must be positive: {slot_capacity}")
        self.slot_capacity = float(slot_capacity)

    def weights(self, priority: np.ndarray, active: np.ndarray) -> np.ndarray:
        return max_min_weights(priority, active, self.slot_capacity)
