"""Host-side online group discovery for the grouped slot plane (counterpart
of ``repro.core.groupby``; the same code, so the same offers give the same
sketch and the same promotions).

The engine's round report carries, per slot, a small salted tally table
``(3, H)`` — ``[count, Σv, Σv²]`` of the slot's group-column values bucketed
by a per-round hash (:func:`repro_torch.kernels.ref.tally_hash`).  The host
folds those tallies into a bounded SpaceSaving sketch (Metwally et al., the
standard O(k)-space heavy-hitter summary) and promotes the heaviest values
into the slot's tracked group cells.  Two properties make the fold sound:

* **Purity.**  A hash bucket is trusted only when its moments prove a single
  occupant value: ``Σv² · count == (Σv)²`` (f64, relative tolerance), i.e.
  the in-bucket variance is zero.  Mixed buckets are skipped.
* **Transience.**  The hash salt is the round number, so two values that
  collide this round almost surely separate next round — a heavy value is
  only ever delayed, never permanently masked.

Everything here is plain numpy on tiny arrays; the sketch never touches the
device.  Dict order matters: :meth:`GroupSketch.top` sorts by count with a
stable sort, so ties keep insertion order, and promotion order decides which
cell a value gets.
"""

from __future__ import annotations

import numpy as np

# relative tolerance for the single-occupant moment test; tally moments are
# f32 sums, so pure buckets land ~1e-7·count away from exact equality
PURITY_RTOL = 1e-4


def pure_buckets(tal: np.ndarray, rtol: float = PURITY_RTOL,
                 ) -> list[tuple[float, float]]:
    """Provably single-value buckets of one ``(3, H)`` tally row:
    ``[(value, count), ...]`` for every bucket whose moments pass the
    zero-variance test; mixed buckets (transient collisions) are dropped."""
    cnt = np.asarray(tal[0], np.float64)
    vsum = np.asarray(tal[1], np.float64)
    vsq = np.asarray(tal[2], np.float64)
    lhs = vsq * cnt
    rhs = vsum * vsum
    scale = np.maximum(np.maximum(np.abs(lhs), np.abs(rhs)), 1.0)
    pure = (cnt > 0) & (np.abs(lhs - rhs) <= rtol * scale)
    out = []
    for b in np.nonzero(pure)[0]:
        # the mean of n copies of one f32 value recovers it; snap to f32 so
        # sketch keys match the engine's cell-equality test bit for bit
        out.append((float(np.float32(vsum[b] / cnt[b])), float(cnt[b])))
    return out


class GroupSketch:
    """Bounded SpaceSaving heavy-hitter sketch over one slot's group column.

    ``offer(value, count)`` is the weighted SpaceSaving update: tracked
    values accumulate, a new value takes over the minimum-count entry when
    the sketch is full (inheriting its count as the overestimation bound).
    ``top(k)`` returns the k heaviest ``(value, count)`` pairs."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("GroupSketch capacity must be >= 1")
        self.capacity = int(capacity)
        self.counts: dict[float, float] = {}
        self.errors: dict[float, float] = {}
        # total pure-bucket mass absorbed: promotion waits for enough of it
        # (a sketch that has seen too little is ranked by noise)
        self.mass = 0.0

    def __len__(self) -> int:
        return len(self.counts)

    def offer(self, value: float, count: float) -> None:
        if count <= 0:
            return
        self.mass += count
        if value in self.counts:
            self.counts[value] += count
        elif len(self.counts) < self.capacity:
            self.counts[value] = count
            self.errors[value] = 0.0
        else:
            victim = min(self.counts, key=self.counts.get)
            floor = self.counts.pop(victim)
            self.errors.pop(victim, None)
            self.counts[value] = floor + count
            self.errors[value] = floor

    def fold(self, tal: np.ndarray, rtol: float = PURITY_RTOL) -> None:
        """Fold one round's ``(3, H)`` tally row into the sketch."""
        for value, count in pure_buckets(tal, rtol):
            self.offer(value, count)

    def top(self, k: int) -> list[tuple[float, float]]:
        order = sorted(self.counts.items(), key=lambda kv: -kv[1])
        return order[:k]

    def guaranteed(self, value: float) -> float:
        """Lower bound on the value's true tallied count (count − error)."""
        return self.counts.get(value, 0.0) - self.errors.get(value, 0.0)


def promote_values(sketch: GroupSketch, tracked: list[float],
                   max_groups: int) -> list[float]:
    """Sketch values to promote into free tracked cells (grow-only): the
    heavy hitters not yet tracked, heaviest first, at most the number of
    free cells.  Promotion never evicts a tracked cell — only the
    ``__other__`` spill restarts when the tracked set grows."""
    free = max_groups - len(tracked)
    if free <= 0:
        return []
    seen = set(tracked)
    out = []
    for value, _ in sketch.top(max_groups):
        if value not in seen:
            out.append(value)
            if len(out) == free:
                break
    return out
