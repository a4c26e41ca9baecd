"""Tier-1 rollup answer cache in front of the OLA workload server
(counterpart of ``repro.serve.rollup``).

A repeated query pattern costs scan rounds every time it arrives.  This
module adds the two-tier shape of OLAP serving: pre-aggregated rollup
cells answer the hot patterns at once, and the shared raw scan serves the
long tail.

* **pattern mining** — every completed query's ``(measure,
  predicate-template)`` pattern is logged; a pattern seen ``promote_hits``
  times inside the sliding mining window is *promoted* to a rollup cell;
* **incremental maintenance** — a cell holds per-chunk sufficient
  statistics ``{m, ysum, ysq, psum}`` (the contract of
  :meth:`~repro_torch.core.synopsis.BiLevelSynopsis.seed_slot` and
  :func:`~repro_torch.core.engine.slot_stats_snapshot`), folded from rows
  the engine already emits: resident slots running the pattern fold out
  once a round (:func:`~repro_torch.core.engine.slot_stats_fold`, one
  batched device-to-host copy, none when no such slot is resident), and
  every retirement folds its final row.  Folding is *replacement by the
  larger per-chunk sample*: each row is a union of windows of the chunk's
  committed permutation, so the bigger row subsumes the smaller one —
  never added, never double counted;
* **tiered answers** — a cell answers through the engine's bi-level
  estimators: chunks with ``m == M_j`` contribute exactly (the FPC zeroes
  their within-chunk variance), the rest a synopsis-style CI;
* **routing** — a rollup answer that meets the query's accuracy target
  costs zero scan seconds and beats any admit/queue/shed plan
  (:data:`repro_torch.sched.admission.TIER1`); one that falls short still
  seeds the scan, richer than the synopsis;
* **invalidation and demotion** — cells pin the store's
  ``content_version`` and are dropped when the raw bytes change; cells
  covering a quarantined chunk are dropped; cold patterns (no hit for
  ``cold_after_s`` modeled seconds) are demoted, and the cell store is
  LRU-bounded at ``max_cells``.

Every row folded into a cell describes tuples from windows of each chunk's
committed permutation inside the scan's extracted prefix, and the scan
continues past its cursor, so a cell used as an admission seed composes
with later round deltas without overlap.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.queries import Query, linear_plan


def pattern_key(query: Query, num_cols: int) -> Optional[tuple]:
    """Canonical ``(measure, predicate-template)`` cell key: the aggregate
    kind and the exact float32 ``coeffs/lo/hi`` lowering of
    :func:`linear_plan`, so textually different but equivalent predicates
    collide.  ε, confidence and HAVING are not part of the key: repeats at
    other targets share one cell and judge its answer against their own.
    ``None`` for queries outside the linear+range form (never cached)."""
    try:
        plan = linear_plan([query], num_cols)
    except ValueError:
        return None
    return (query.agg, plan.coeffs[0].tobytes(), plan.lo[0].tobytes(),
            plan.hi[0].tobytes())


@dataclasses.dataclass(frozen=True)
class RollupConfig:
    """Promotion and demotion policy of the Tier-1 cell store."""

    # completions of a pattern (inside the mining window) before promotion
    promote_hits: int = 2
    # LRU capacity of the cell store
    max_cells: int = 64
    # demote a cell untouched for this many modeled seconds (inf: never)
    cold_after_s: float = math.inf
    # sliding completed-query log length the miner counts over
    mine_window: int = 256

    def __post_init__(self):
        for name in ("promote_hits", "max_cells", "mine_window"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")


class RollupCell:
    """One promoted pattern's partial aggregate: per-chunk sufficient
    statistics over the chunks the scan has covered for it so far."""

    def __init__(self, key: tuple, query: Query, n_chunks: int,
                 now: float, content_version: int):
        self.key = key
        self.query = query              # exemplar (ε/HAVING ignored)
        self.content_version = content_version
        self.created_t = now
        self.last_hit_t = now
        self.hits = 0                   # Tier-1 answers served from the cell
        self.folds = 0
        self.m = np.zeros(n_chunks, np.int64)
        self.ysum = np.zeros(n_chunks, np.float64)
        self.ysq = np.zeros(n_chunks, np.float64)
        self.psum = np.zeros(n_chunks, np.float64)

    def fold(self, row: dict) -> int:
        """Merge one statistics row into the cell: per chunk, the larger
        sample *replaces* the cell's.  Returns the chunks upgraded."""
        m = np.asarray(row["m"], np.int64)
        take = m > self.m
        n = int(take.sum())
        if n:
            self.m[take] = m[take]
            self.ysum[take] = np.asarray(row["ysum"], np.float64)[take]
            self.ysq[take] = np.asarray(row["ysq"], np.float64)[take]
            self.psum[take] = np.asarray(row["psum"], np.float64)[take]
            self.folds += 1
        return n

    def seed_dict(self) -> dict:
        """The cell as a ``{m, ysum, ysq, psum}`` seed row (the synopsis
        seed's contract)."""
        return dict(m=self.m.copy(), ysum=self.ysum.copy(),
                    ysq=self.ysq.copy(), psum=self.psum.copy())

    def covered(self, chunk_sizes: np.ndarray) -> np.ndarray:
        """Fully covered chunks (the exact part of a tiered answer)."""
        return self.m >= np.asarray(chunk_sizes, np.int64)

    def touch(self, now: float) -> None:
        self.hits += 1
        self.last_hit_t = max(self.last_hit_t, now)


class RollupTier:
    """The Tier-1 cell store and pattern miner (see the module docstring).
    Host-side and engine-free: the server builds the answers (the
    estimator stack on :meth:`RollupCell.seed_dict` rows) and feeds
    completions and fold rows in; this class decides which patterns are
    materialized and when cells die."""

    COUNTER_FIELDS = ("tier1_hits", "promotions", "demotions",
                      "invalidations")

    def __init__(self, store, config: RollupConfig = RollupConfig(),
                 num_cols: Optional[int] = None):
        self.store = store
        self.config = config
        self.num_cols = (store.codec.num_cols if num_cols is None
                         else int(num_cols))
        self.n_chunks = store.num_chunks
        self.content_version = int(getattr(store, "content_version", 0))
        self.cells: dict[tuple, RollupCell] = {}
        self._log: deque[tuple] = deque()   # completed-query pattern log
        self._counts: dict[tuple, int] = {}
        self.tier1_hits = 0
        self.promotions = 0
        self.demotions = 0
        self.invalidations = 0

    def counters(self) -> dict:
        """The tier's monotone counters and the current cell count."""
        out = {f: int(getattr(self, f)) for f in self.COUNTER_FIELDS}
        out["cells"] = len(self.cells)
        return out

    def bind_metrics(self, registry, prefix: str = "rollup") -> None:
        """Pull gauges for every counter on a
        :class:`~repro_torch.obs.metrics.MetricsRegistry`."""
        for f in self.COUNTER_FIELDS:
            registry.gauge(f"{prefix}_{f}",
                           help=f"RollupTier.{f} (cumulative)",
                           fn=(lambda f=f: getattr(self, f)))
        registry.gauge(f"{prefix}_cells", help="materialized rollup cells",
                       fn=lambda: len(self.cells))

    # ----------------------------------------------------------- mining ----
    def observe(self, query: Query, key: Optional[tuple],
                now: float) -> Optional[RollupCell]:
        """Log one completed query.  Returns the cell iff this completion
        *newly promoted* the pattern; a promoted pattern's completions
        refresh its recency."""
        if key is None:
            return None
        self._log.append(key)
        self._counts[key] = self._counts.get(key, 0) + 1
        while len(self._log) > self.config.mine_window:
            old = self._log.popleft()
            self._counts[old] = max(self._counts.get(old, 1) - 1, 0)
        cell = self.cells.get(key)
        if cell is not None:
            cell.last_hit_t = max(cell.last_hit_t, now)
            return None
        if self._counts[key] < self.config.promote_hits:
            return None
        cell = RollupCell(key, query, self.n_chunks, now,
                          self.content_version)
        self.cells[key] = cell
        self.promotions += 1
        self._evict_lru()
        return cell

    def _evict_lru(self) -> None:
        while len(self.cells) > self.config.max_cells:
            lru = min(self.cells.values(), key=lambda c: c.last_hit_t)
            self._demote(lru.key)

    def _demote(self, key: tuple) -> None:
        self.cells.pop(key, None)
        # a demoted pattern needs fresh evidence: its stale log entries
        # must not resurrect the cell at once
        self._counts[key] = 0
        self.demotions += 1

    # ------------------------------------------------------- maintenance ----
    def maintain(self, now: float) -> None:
        """Drop every cell when the store's content changed, demote cold
        cells.  Called once per intake pass (O(cells))."""
        version = int(getattr(self.store, "content_version", 0))
        if version != self.content_version:
            # the miner's log survives: hot patterns re-promote and rebuild
            # over the new content
            if self.cells:
                self.invalidations += len(self.cells)
                self.cells.clear()
            self.content_version = version
        if math.isfinite(self.config.cold_after_s):
            cold = [k for k, c in self.cells.items()
                    if now - c.last_hit_t > self.config.cold_after_s]
            for k in cold:
                self._demote(k)

    def invalidate_chunks(self, chunk_ids) -> int:
        """Drop every cell with sample in a quarantined chunk (its answer
        counts tuples outside the surviving population).  Returns the cells
        dropped; the miner's log survives."""
        ids = [int(j) for j in chunk_ids]
        if not ids:
            return 0
        stale = [k for k, c in self.cells.items()
                 if int(c.m[ids].sum()) > 0]
        for k in stale:
            self.cells.pop(k, None)
        self.invalidations += len(stale)
        return len(stale)

    # ------------------------------------------------------------ lookup ----
    def get(self, key: Optional[tuple]) -> Optional[RollupCell]:
        """The promoted cell of a pattern key, or None."""
        if key is None:
            return None
        return self.cells.get(key)

    def fold(self, key: Optional[tuple], row: dict) -> None:
        cell = self.get(key)
        if cell is not None:
            cell.fold(row)
