"""Estimation controller — the paper's δ-interval reporting loop (counterpart
of ``repro.core.controller``).

The controller owns the modeled wall clock (Eq. 4: READ and EXTRACT overlap,
so a round costs ``max(t_io, t_cpu)``), the δ-interval estimate reports, the
HAVING-sequence early-outs, and the synopsis life-cycle across a query
sequence (build → reuse → rebuild).  It drives the frozen query plane,
one query batch at a time (:meth:`EstimationController.run_query`) or as
the paper's verification chain of HAVING queries
(:meth:`EstimationController.run_verification`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import estimators as E
from repro_torch.core.engine import EngineConfig, OLAEngine
from repro_torch.core.queries import Query
from repro_torch.core.synopsis import BiLevelSynopsis
from repro_torch.device import resolve_device
from repro_torch.sampling.permutation import random_chunk_order


@dataclasses.dataclass
class EstimateReport:
    """One user-visible estimate row (emitted every δ of modeled time)."""

    t_model: float            # modeled seconds since query start (Eq. 4 clock)
    t_wall: float             # measured wall seconds
    estimate: np.ndarray      # (Q,)
    lo: np.ndarray
    hi: np.ndarray
    err: np.ndarray           # (Q,) error ratio
    n_chunks: int
    m_tuples: int
    io_busy: float
    cpu_busy: float


@dataclasses.dataclass
class QueryResult:
    reports: list[EstimateReport]
    final_estimate: np.ndarray
    final_err: np.ndarray
    decisions: np.ndarray     # (Q,) int8 HAVING verdicts
    stopped: np.ndarray       # (Q,) bool
    rounds: int
    t_model_total: float
    t_wall_total: float
    tuples_ratio: float       # fraction of the table's tuples extracted
    chunks_ratio: float       # fraction of chunks read from raw
    from_synopsis: bool = False


class EstimationController:
    """Drives an :class:`OLAEngine` round loop with δ-interval reporting and
    synopsis reuse.  Runs on the CUDA device unless ``device`` says
    otherwise."""

    def __init__(self, store, config: EngineConfig, delta_model_s: float = 1.0,
                 synopsis_budget_tuples: int = 0, device=None):
        self.device = resolve_device(device)
        self.store = store
        self.config = config
        self.delta = float(delta_model_s)
        self.synopsis: Optional[BiLevelSynopsis] = None
        if synopsis_budget_tuples > 0:
            self.synopsis = BiLevelSynopsis(
                n_chunks=store.num_chunks, num_cols=store.codec.num_cols,
                budget_tuples=synopsis_budget_tuples,
                chunk_sizes=store.chunk_sizes)

    # ----------------------------------------------------------------- run --
    def run_query(self, queries: Sequence[Query], max_rounds: int = 200_000,
                  wall_timeout_s: float = 600.0) -> QueryResult:
        queries = list(queries)
        cfg = self.config
        use_syn = (self.synopsis is not None and len(self.synopsis.chunks) > 0
                   and self.synopsis.supports(queries))
        if (self.synopsis is not None and not use_syn
                and len(self.synopsis.chunks) > 0):
            self.synopsis.rebuild()   # unservable query -> automatic rebuild

        cache_cap = cfg.cache_cap
        if self.synopsis is not None and cache_cap == 0:
            # the extraction cache builds and maintains the synopsis
            cache_cap = max(64, int(np.ceil(
                4 * self.synopsis.budget / max(self.store.num_chunks, 1))))
            cfg = dataclasses.replace(cfg, cache_cap=cache_cap)

        schedule = None
        seed = None
        if use_syn:
            base = random_chunk_order(cfg.seed, self.store.num_chunks)
            if self.synopsis.origin_schedule is not None:
                base = self.synopsis.origin_schedule
            schedule = self.synopsis.plan_schedule(base)
            seed = self.synopsis.seed(queries, cache_cap)

        engine = OLAEngine(self.store, queries, cfg, schedule=schedule,
                           device=self.device)
        state = engine.init_state(seed)

        if seed is not None:
            zero = self._try_answer_from_seed(engine, queries, seed)
            if zero is not None:
                engine.close()
                return zero

        reports: list[EstimateReport] = []
        t_model = 0.0
        next_report = 0.0
        t0 = time.perf_counter()
        rounds = 0
        last = None
        for _ in range(max_rounds):
            b = engine.budget_ladder(float(state.budget))
            state, data = engine.round_data(state)
            mode, data = engine.data_mode(data)
            state, rep = engine.round_fn(b, mode)(state, data, engine.speeds)
            rounds += 1
            io_s = float(rep.round_io_s)
            cpu_s = float(rep.round_cpu_s)
            # Eq. 4 overlapped-pipeline clock
            t_model = max(float(state.t_io), float(state.t_cpu))
            step_t = max(io_s, cpu_s)
            last = rep
            done = bool(rep.all_stopped) or bool(rep.exhausted)
            if t_model >= next_report or done:
                reports.append(EstimateReport(
                    t_model=t_model, t_wall=time.perf_counter() - t0,
                    estimate=rep.estimate.cpu().numpy(),
                    lo=rep.lo.cpu().numpy(), hi=rep.hi.cpu().numpy(),
                    err=rep.err.cpu().numpy(),
                    n_chunks=int(rep.n_chunks), m_tuples=int(rep.m_tuples),
                    io_busy=io_s / max(step_t, 1e-12),
                    cpu_busy=cpu_s / max(step_t, 1e-12)))
                next_report = t_model + self.delta
            if done:
                break
            if time.perf_counter() - t0 > wall_timeout_s:
                break

        # synopsis maintenance from this run's extraction cache
        if self.synopsis is not None:
            variances = self.synopsis.within_variances(state)
            self.synopsis.update_from_engine(
                state, engine.program.schedule_np, variances)
        engine.close()

        chunks_raw = int(state.raw_touched.sum())
        return QueryResult(
            reports=reports,
            final_estimate=last.estimate.cpu().numpy(),
            final_err=last.err.cpu().numpy(),
            decisions=last.decided.cpu().numpy(),
            stopped=state.stopped.cpu().numpy(),
            rounds=rounds,
            t_model_total=t_model,
            t_wall_total=time.perf_counter() - t0,
            tuples_ratio=float(int(last.m_tuples)
                               / max(engine.program.total_tuples, 1)),
            chunks_ratio=chunks_raw / max(engine.program.n_chunks, 1),
            from_synopsis=use_syn,
        )

    def _try_answer_from_seed(self, engine, queries, seed):
        """Section 6.3 best case: the query is answered from the synopsis
        alone — zero raw access, zero modeled time."""
        est_v, lo, hi, err = _answer_from_stats(
            queries, engine.init_state(seed).stats)
        est_v, lo, hi, err = (t.cpu().numpy() for t in (est_v, lo, hi, err))
        decided = np.full(len(queries), -1, np.int8)
        stop = err <= np.asarray([q.epsilon for q in queries])
        for qi, q in enumerate(queries):
            if q.having is not None:
                d = int(E.having_decision(lo[qi], hi[qi], q.having.op,
                                          q.having.threshold))
                decided[qi] = d
                stop[qi] |= d != -1
        if not stop.all():
            return None
        return QueryResult(
            reports=[EstimateReport(
                t_model=0.0, t_wall=0.0, estimate=est_v, lo=lo, hi=hi,
                err=err, n_chunks=int(np.sum(np.asarray(seed["m"]) > 0)),
                m_tuples=int(np.sum(seed["m"])), io_busy=0.0, cpu_busy=0.0)],
            final_estimate=est_v, final_err=err, decisions=decided,
            stopped=stop, rounds=0, t_model_total=0.0, t_wall_total=0.0,
            tuples_ratio=float(np.sum(seed["m"])
                               / max(self.store.num_tuples, 1)),
            chunks_ratio=0.0, from_synopsis=True)


    # -------------------------------------------------- verification chain --
    def run_verification(self, queries: Sequence[Query],
                         max_rounds: int = 200_000) -> list[QueryResult]:
        """The PTF workflow (Section 1): HAVING queries run in sequence, and
        a query runs only if every previous one passed.  The chain stops
        after the first rejected query; a query whose verdict is still
        undecided at its stop passes when its point estimate satisfies the
        HAVING clause (the estimate is exact once the scan was exhausted).
        Each query reuses (and refreshes) the synopsis."""
        queries = list(queries)
        for q in queries:
            if q.having is None:
                raise ValueError(f"verification query {q.name!r} has no "
                                 "HAVING clause")
        results = []
        for q in queries:
            res = self.run_query([q], max_rounds=max_rounds)
            results.append(res)
            verdict = int(res.decisions[0])
            passed = verdict == 1 or (verdict == -1
                                      and _having_exact_pass(q, res))
            if not passed:
                break   # batch rejected: the rest never runs
        return results


def _having_exact_pass(q: Query, res: QueryResult) -> bool:
    """Judge an undecided HAVING verdict on the point estimate (exact when
    the engine exhausted the data)."""
    v = float(res.final_estimate[0])
    t = q.having.threshold
    return {"<": v < t, "<=": v <= t, ">": v > t, ">=": v >= t}[q.having.op]


def _answer_from_stats(queries, stats):
    """``(estimate, lo, hi, err)`` tensors, one entry per query, from a
    statistics row with a leading query dimension."""
    ests, vars_ = [], []
    for qi, q in enumerate(queries):
        if q.agg == "sum":
            t = E.tau_hat(stats)[qi]
            v = E.var_hat(stats)[0][qi]
        elif q.agg == "count":
            t = E.count_tau_hat(stats)[qi]
            v = E.count_var_hat(stats)[0][qi]
        else:
            r, vv, _ = E.avg_estimate(stats)
            t, v = r[qi], vv[qi]
        ests.append(t)
        vars_.append(v)
    est_v = torch.stack(ests)
    var_v = torch.stack(vars_)
    lo, hi = E.confidence_bounds(est_v, var_v, queries[0].confidence)
    err = E.error_ratio(est_v, lo, hi)
    return est_v, lo, hi, err
