"""Memory-resident bi-level sample synopsis — paper Section 6 (counterpart of
``repro.core.synopsis``).

The synopsis caches, under a tuple budget, a circular window into each
chunk's keyed permutation together with the extracted column values, so
later queries can be estimated without touching raw data.  A window is a
contiguous run of the chunk's random order, so whatever survives shrinking
is still a uniform without-replacement sample.

On budget pressure the budget is split across chunks in proportion to their
within-chunk variance, and shrinking drops tuples from the front of each
window.  Under the workload server the synopsis absorbs the shared scan's
extraction cache on demand, and :meth:`seed_slot` produces the stats rows of
a query admitted mid-scan.  Everything here is host-side numpy over copies
of the engine's device arrays; queries are evaluated on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.queries import Query, compile_queries


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass
class SynopsisChunk:
    start: int                 # window start in the chunk's permutation order
    values: np.ndarray         # (count, C) extracted tuples, window order

    @property
    def count(self) -> int:
        return int(self.values.shape[0])


class BiLevelSynopsis:
    """Budgeted cache of per-chunk permutation windows."""

    def __init__(self, n_chunks: int, num_cols: int, budget_tuples: int,
                 chunk_sizes: np.ndarray):
        self.n_chunks = int(n_chunks)
        self.num_cols = int(num_cols)
        self.budget = int(budget_tuples)
        self.chunk_sizes = np.asarray(chunk_sizes, np.int64)
        self.chunks: dict[int, SynopsisChunk] = {}
        self.origin_schedule: Optional[np.ndarray] = None
        self.columns_cached: frozenset = frozenset(range(num_cols))
        self.rebuilds = 0

    # ------------------------------------------------------------ queries --
    def supports(self, queries: Sequence[Query]) -> bool:
        """A query sequence can reuse the synopsis iff its column support is
        cached (otherwise a full rebuild is triggered)."""
        need = set()
        for q in queries:
            need |= set(q.columns_used)
        if -1 in need:  # unknown support (Custom expression) -> all columns
            need = set(range(self.num_cols))
        return need <= set(self.columns_cached)

    @property
    def total_tuples(self) -> int:
        return sum(c.count for c in self.chunks.values())

    # -------------------------------------------------------------- build --
    def update_from_engine(self, state, schedule: np.ndarray,
                           query_variances: np.ndarray) -> None:
        """Absorb an engine run's extraction cache (Section 6.1/6.2).

        Chunks are visited in schedule order; a window merges with an
        existing window for the same chunk (engine cursors continued from
        the window end, so cached rows align with window ordinals).
        Extraction counts come from the scan-level ``scan_m``."""
        cache = _host(state.cache)               # (N, cap, C)
        m = _host(state.scan_m)                  # (N,) scan-level
        cached_m = _host(state.cached_m)
        offset = _host(state.offset)
        cap = cache.shape[1]
        if self.origin_schedule is None:
            self.origin_schedule = np.asarray(schedule).copy()

        for j in np.asarray(schedule):
            j = int(j)
            mj = int(m[j])
            if mj <= 0:
                continue
            have = self.chunks.get(j)
            rows = min(mj, cap)
            vals = cache[j, :rows]
            if have is not None and int(cached_m[j]) > 0:
                # the engine was seeded from this window: splice the existing
                # window and the newly extracted tail
                new_rows = cache[j, int(cached_m[j]):rows]
                vals = np.concatenate([have.values, new_rows], axis=0)
                start = have.start
            else:
                start = int(offset[j]) - mj if int(offset[j]) >= mj else 0
            self.chunks[j] = SynopsisChunk(start=start, values=np.asarray(vals))

        self._fit_budget(query_variances)

    def _fit_budget(self, variances: np.ndarray) -> None:
        """Variance-proportional allocation + keep-the-tail shrinking."""
        if self.total_tuples <= self.budget:
            return
        js = sorted(self.chunks.keys())
        v = np.maximum(np.asarray([variances[j] for j in js], np.float64), 1e-12)
        alloc = np.floor(self.budget * v / v.sum()).astype(np.int64)
        alloc = np.maximum(alloc, 1)  # every admitted chunk keeps >= 1 tuple
        while alloc.sum() > self.budget:
            k = int(np.argmax(alloc))
            alloc[k] -= 1
        for idx, j in enumerate(js):
            ch = self.chunks[j]
            keep = int(min(alloc[idx], ch.count))
            if keep < ch.count:
                drop = ch.count - keep
                # drop the front of the random permutation (paper Fig. 6)
                self.chunks[j] = SynopsisChunk(
                    start=(ch.start + drop) % max(int(self.chunk_sizes[j]), 1),
                    values=ch.values[drop:])

    def drop_chunks(self, chunk_ids) -> int:
        """Forget windows over quarantined chunks: a lost or corrupt chunk
        is out of the surviving population, so its cached tuples must stop
        seeding estimates.  Returns the number of windows dropped."""
        n = 0
        for j in chunk_ids:
            if self.chunks.pop(int(j), None) is not None:
                n += 1
        return n

    # ---------------------------------------------------------- estimation --
    def within_variances(self, state) -> np.ndarray:
        """Per-chunk within-variance proxy from engine stats (allocation key):
        the origin query in frozen mode, the max across slots in slot mode."""
        m = _host(state.stats.m).astype(np.float64)
        ys = _host(state.stats.ysum).astype(np.float64)
        yq = _host(state.stats.ysq).astype(np.float64)
        if m.ndim == 1:
            ys, yq = ys[0], yq[0]
            ss = yq - np.where(m > 0, ys * ys / np.maximum(m, 1.0), 0.0)
            return np.maximum(ss / np.maximum(m - 1.0, 1.0), 0.0)
        ss = yq - np.where(m > 0, ys * ys / np.maximum(m, 1.0), 0.0)
        v = np.maximum(ss / np.maximum(m - 1.0, 1.0), 0.0)
        return v.max(axis=0)

    @staticmethod
    def _evaluate(evaluate, values: np.ndarray):
        x, p = evaluate(torch.from_numpy(np.asarray(values, np.float32)))
        return x.numpy(), p.numpy()

    def seed(self, queries: Sequence[Query], cache_cap: int) -> dict:
        """Engine seed for a follow-up query (Section 6.3): evaluate the new
        queries over the cached tuples and pre-fill stats and cursors."""
        qn = len(queries)
        n = self.n_chunks
        evaluate = compile_queries(queries)
        m = np.zeros(n, np.int32)
        ysum = np.zeros((qn, n), np.float32)
        ysq = np.zeros((qn, n), np.float32)
        psum = np.zeros((qn, n), np.float32)
        offset = np.zeros(n, np.int32)
        cache = np.zeros((n, cache_cap, self.num_cols), np.float32)
        for j, ch in self.chunks.items():
            if ch.count == 0:
                continue
            x, p = self._evaluate(evaluate, ch.values)
            m[j] = ch.count
            ysum[:, j] = x.sum(-1)
            ysq[:, j] = (x * x).sum(-1)
            psum[:, j] = p.sum(-1)
            offset[j] = ch.start + ch.count   # cursor continues past the window
            rows = min(ch.count, cache_cap)
            cache[j, :rows] = ch.values[:rows]
        return dict(m=m, ysum=ysum, ysq=ysq, psum=psum, offset=offset,
                    cache=cache)

    def seed_slot(self, query: Query) -> Optional[dict]:
        """Per-slot sufficient-statistics rows ``{m, ysum, ysq, psum}`` (each
        ``(N,)``) for one mid-scan admission, or ``None`` when the synopsis
        is empty or cannot serve the query's columns.  The seeded windows
        and the scan's future extraction are disjoint index sets of one
        keyed permutation, so round deltas simply add on top."""
        if not self.chunks or not self.supports([query]):
            return None
        n = self.n_chunks
        evaluate = compile_queries([query])
        m = np.zeros(n, np.int32)
        ysum = np.zeros(n, np.float32)
        ysq = np.zeros(n, np.float32)
        psum = np.zeros(n, np.float32)
        for j, ch in self.chunks.items():
            if ch.count == 0:
                continue
            x, p = self._evaluate(evaluate, ch.values)
            x, p = x[0], p[0]
            m[j] = ch.count
            ysum[j] = x.sum()
            ysq[j] = (x * x).sum()
            psum[j] = p.sum()
        return dict(m=m, ysum=ysum, ysq=ysq, psum=psum)

    def plan_schedule(self, base_schedule: np.ndarray,
                      by_variance: Optional[np.ndarray] = None) -> np.ndarray:
        """Chunk order for a follow-up query (Section 6.3): chunks missing
        from the synopsis first, cached ones after, both in original order;
        with everything cached, optionally by decreasing variance."""
        base = np.asarray(base_schedule)
        cached = np.asarray([j in self.chunks for j in base])
        if not cached.all():
            return np.concatenate([base[~cached], base[cached]]).astype(np.int32)
        if by_variance is not None:
            order = np.argsort(-by_variance[base], kind="stable")
            return base[order].astype(np.int32)
        return base.astype(np.int32)

    def rebuild(self) -> None:
        """Full reset (a query the synopsis cannot serve triggers one)."""
        self.chunks.clear()
        self.origin_schedule = None
        self.rebuilds += 1
