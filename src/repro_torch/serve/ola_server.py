"""Workload serving for OLA queries: one shared scan, many concurrent queries
(counterpart of ``repro.serve.ola_server``).

Aggregate queries arrive as a stream and are multiplexed onto a single
shared scan of the raw table:

* **slots** — up to ``max_slots`` queries are resident at once, described by
  a :class:`~repro_torch.core.queries.SlotTable` the round step takes as data;
* **mid-scan admission** — a query joining a running scan is seeded from the
  :class:`~repro_torch.core.synopsis.BiLevelSynopsis`, so it starts with an
  estimate over the already-started chunk set instead of cold;
* **early leave** — a query retires the moment its HAVING verdict or ε target
  is met, without stopping the scan for the others;
* **top-up passes** — if the scan wound down but a resident query needs more
  data, the server re-opens non-exhausted chunks and rewinds the schedule
  head; per-chunk permutation cursors continue;
* **per-query plan selection** — :func:`select_plan` picks a strategy per
  admitted query from the Eq. (4) cost terms;
* **online GROUP BY** — with ``EngineConfig(max_groups=...)`` a
  ``Query(group_by=GroupBy(...))`` owns group cells in its slot; each
  round's group tallies feed the slot's SpaceSaving sketch, its heavy
  hitters are promoted into cells, and the answer arrives as
  ``WorkloadResult.groups``.

This package serves the unscheduled path on one device, with packed or
streaming residency (``EngineConfig.residency``; the decoded-chunk cache
with ``decoded_cache_bytes``).  A chunk whose reads fail for good is
quarantined: the answers of every query live at or after that moment
describe the surviving population and are flagged ``degraded``.  The SLO
scheduler, the rollup tier (with its per-group cell mining), multi-device
meshes and injected engines raise ``NotImplementedError`` until their slices
land.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import estimators as est
from repro_torch.core.controller import _answer_from_stats
from repro_torch.core.engine import (
    IDLE,
    EngineConfig,
    SlotOLAEngine,
    quarantine_chunks,
    slot_stats_write,
    zero_group_cells,
)
from repro_torch.core.groupby import GroupSketch, promote_values
from repro_torch.core.queries import (
    PLAN_CODES,
    GroupResult,
    Query,
    empty_slot_table,
    encode_slot,
    slot_table_clear,
    slot_table_set,
    slot_table_set_groups,
)
from repro_torch.core.synopsis import BiLevelSynopsis
from repro_torch.device import resolve_device
from repro_torch.obs.explain import ExplainRecord, RoundSample
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sched.admission import eq4_cost_terms, scan_tuples_per_s


@dataclasses.dataclass(frozen=True)
class MeasuredRates:
    """Measured IO/CPU rates for the Eq. (4) cost model: the aggregate
    extraction throughput of one round step across ``workers`` workers and
    the raw read bandwidth.  :func:`select_plan` rescales the CPU rate to the
    serving config's worker count; the modeled :class:`EngineConfig`
    constants are the fallback when no measurement is given."""

    io_bytes_per_sec: float
    cpu_tuples_per_sec: float
    workers: int = 1
    source: str = "measured"
    # extraction cost of the calibration store (0 = unknown, no rescaling)
    cost_per_tuple: float = 0.0


def select_plan(store, config: EngineConfig, query: Query,
                rates: Optional[MeasuredRates] = None,
                decoded_fraction: float = 0.0) -> str:
    """Cost-model plan selector for one admitted query (paper Fig. 11):

    * ``epsilon <= 0`` (exact answer demanded): ``chunk_level``;
    * IO-bound (``T_cpu < T_io / 2``): ``holistic``;
    * CPU-bound (``T_cpu > 2 T_io``): ``single_pass``;
    * otherwise ``resource_aware``, letting the runtime monitor switch.
    """
    t_io, t_cpu = eq4_cost_terms(store, config, rates,
                                 decoded_fraction=decoded_fraction)
    if query.epsilon <= 0.0:
        return "chunk_level"
    ratio = t_cpu / max(t_io, 1e-12)
    if ratio < 0.5:
        return "holistic"
    if ratio > 2.0:
        return "single_pass"
    return "resource_aware"


@dataclasses.dataclass(frozen=True)
class ServerOptions:
    """Construction options for :class:`OLAWorkloadServer`.

    ``scheduler``, ``rollup``, ``mesh`` and ``engine`` belong to later
    slices of this package and raise ``NotImplementedError`` when set."""

    max_slots: int = 8
    synopsis_budget_tuples: int = 4096
    confidence: float = 0.95
    schedule: Optional[np.ndarray] = None
    measured_rates: Optional[MeasuredRates] = None
    tracer: object = None
    metrics: Optional[MetricsRegistry] = None
    scheduler: object = None
    rollup: object = None
    mesh: object = None
    engine: object = None
    # grouped discovery: the pure-tally mass (tuples) a slot's sketch must
    # absorb before values are promoted into tracked cells.  Promotion is
    # grow-only, so promoting off a few noisy early rounds would lock true
    # heavy hitters out of the cells for good.
    group_warmup_tuples: int = 1024


@dataclasses.dataclass
class WorkloadQuery:
    """One submitted query: the aggregate plus its workload metadata."""

    qid: int
    query: Query
    arrival_t: float = 0.0          # modeled seconds on the server clock
    plan: Optional[str] = None      # None -> cost-model selector
    row: Optional[dict] = None      # slot row encoded (and validated) at submit
    queued: bool = False            # waited >= one admission pass for a slot
    explain: Optional[ExplainRecord] = None


@dataclasses.dataclass
class WorkloadResult:
    qid: int
    name: str
    estimate: float
    lo: float
    hi: float
    err: float
    decision: int                   # HAVING verdict (-1/0/1)
    plan: str
    t_submit: float                 # arrival (modeled s)
    t_admit: float                  # slot grant (modeled s)
    t_done: float                   # retirement (modeled s)
    seeded_tuples: int              # tuples supplied by the synopsis at admit
    tuples_seen: int                # slot sample size at retirement
    rounds_resident: int
    from_synopsis: bool = False     # answered at admission, zero scan rounds
    unserved: bool = False          # scan exhausted before the slot saw any
                                    # tuple (no synopsis seed): estimate NaN
    sched_outcome: str = "admitted"  # "admitted" or "queued" (waited for one)
    queue_wait: float = 0.0         # t_admit - t_submit (modeled s)
    # degraded-answer semantics: the estimate speaks for the surviving
    # population because chunks were quarantined (lost or irrecoverably
    # corrupt) before the query completed; ``chunks_quarantined`` is the
    # count at that moment and ``read_retries`` the retried chunk reads
    # while the query was resident (both 0 on a healthy scan)
    degraded: bool = False
    chunks_quarantined: int = 0
    read_retries: int = 0
    # grouped answer (Query(group_by=...)): one GroupResult per live cell —
    # the tracked values in discovery order, then the __other__ spill
    # (is_other=True).  None for ungrouped queries; the scalar estimate
    # above describes the query's base-predicate population either way.
    groups: Optional[list[GroupResult]] = None
    explain: Optional[ExplainRecord] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def halfwidth(self) -> float:
        return (self.hi - self.lo) / 2.0


class OLAWorkloadServer:
    """Admits a stream of aggregate queries onto one shared OLA scan.

    A host-side loop around :class:`SlotOLAEngine`: ``submit`` enqueues,
    ``step`` runs one engine round (admitting and retiring between rounds),
    ``run`` drives to completion.  The modeled clock is Eq. (4)'s
    overlapped-pipeline time ``max(t_io, t_cpu)`` plus the idle gaps the
    server skips while waiting for arrivals.  The engine, and so the packed
    store, lives on ``device`` — the CUDA device unless the caller names
    another; without one the constructor raises.
    """

    def __init__(self, store, config: EngineConfig,
                 options: Optional[ServerOptions] = None, device=None):
        opts = options if options is not None else ServerOptions()
        for name in ("scheduler", "rollup", "mesh", "engine"):
            if getattr(opts, name) is not None:
                raise NotImplementedError(
                    f"ServerOptions.{name} is not ported to repro_torch yet")
        self.device = resolve_device(device)
        max_slots = opts.max_slots
        if config.cache_cap == 0 and opts.synopsis_budget_tuples > 0:
            # mid-scan seeding needs the extraction cache
            cap = max(64, int(np.ceil(4 * opts.synopsis_budget_tuples
                                      / max(store.num_chunks, 1))))
            config = dataclasses.replace(config, cache_cap=cap)
        self.store = store
        self.config = config
        self.engine = SlotOLAEngine(store, max_slots, config,
                                    schedule=opts.schedule,
                                    confidence=opts.confidence,
                                    device=self.device)
        self.rates = opts.measured_rates
        # the table's group capacity follows the engine's (0: ungrouped)
        self.max_groups = int(self.config.max_groups)
        self.table = empty_slot_table(max_slots, store.codec.num_cols,
                                      self.max_groups, device=self.device)
        self.state = self.engine.init_state()
        self.max_slots = max_slots
        # per-slot online group discovery (grouped occupants only): the
        # SpaceSaving sketch fed from each round's tallies, and the host's
        # list of the slot's tracked values in discovery order
        self._slot_sketch: list[Optional[GroupSketch]] = [None] * max_slots
        self._slot_groups: list[Optional[list[float]]] = [None] * max_slots
        self._group_warmup = int(opts.group_warmup_tuples)
        self.synopsis: Optional[BiLevelSynopsis] = None
        if opts.synopsis_budget_tuples > 0:
            self.synopsis = BiLevelSynopsis(
                n_chunks=store.num_chunks, num_cols=store.codec.num_cols,
                budget_tuples=opts.synopsis_budget_tuples,
                chunk_sizes=store.chunk_sizes)
        self.queue: list[WorkloadQuery] = []
        self.slot_wq: list[Optional[WorkloadQuery]] = [None] * max_slots
        self.slot_admit_t = np.zeros(max_slots)
        self.slot_admit_round = np.zeros(max_slots, np.int64)
        self.slot_plan = [""] * max_slots
        self.slot_seeded = np.zeros(max_slots, np.int64)
        self.results: list[WorkloadResult] = []
        self.rounds = 0
        self.topup_passes = 0
        self.idle_offset = 0.0
        self.truncated = False
        self._next_qid = 0
        self._weights = np.ones(max_slots, np.float32)
        # surviving-population bookkeeping: quarantining a chunk shrinks the
        # population every price and estimate describes; re-derived from
        # engine.quarantine_log after each round (see _note_quarantine)
        self._quarantine_seen = 0       # quarantine_log entries consumed
        self._quarantine_count = 0      # chunks quarantined so far
        self._slot_retries0 = np.zeros(max_slots, np.int64)
        self._eff_chunks = int(store.num_chunks)
        self._eff_tuples = int(store.num_tuples)
        self._eff_bytes = (float(np.asarray(store.chunk_sizes).sum())
                           * store.codec.record_bytes)
        self._scan_rate = scan_tuples_per_s(store, self.config,
                                            rates=self.rates)
        self.tracer = opts.tracer if opts.tracer is not None else NULL_TRACER
        if self.tracer.enabled:
            self.engine.set_tracer(self.tracer)
        self.metrics = (opts.metrics if opts.metrics is not None
                        else MetricsRegistry())
        self._bind_metrics()

    def _bind_metrics(self) -> None:
        """Register the server's observable state as pull gauges (read at
        export time, no hot-path writes)."""
        reg = self.metrics
        reg.gauge("server_rounds", help="engine rounds run",
                  fn=lambda: self.rounds)
        reg.gauge("server_topup_passes", help="schedule re-open passes",
                  fn=lambda: self.topup_passes)
        reg.gauge("server_tuples_scanned",
                  help="raw tuples extracted by the shared scan",
                  fn=lambda: self.tuples_scanned)
        reg.gauge("server_queue_depth", help="queries waiting for a slot",
                  fn=lambda: len(self.queue))
        reg.gauge("server_slots_resident", help="occupied scan slots",
                  fn=lambda: sum(w is not None for w in self.slot_wq))
        reg.gauge("server_chunks_quarantined",
                  help="chunks removed from the population",
                  fn=lambda: self._quarantine_count)
        reg.gauge("server_quarantine_events",
                  help="engine quarantine_log length",
                  fn=lambda: len(self.engine.quarantine_log))
        if self.engine.pipeline is not None:
            self.engine.pipeline.bind_metrics(reg)
        injected = getattr(self.store, "injected", None)
        if isinstance(injected, dict):
            for kind in sorted(injected):
                reg.gauge("faults_injected",
                          help="FaultInjector events by kind",
                          labels={"kind": kind},
                          fn=(lambda k=kind: self.store.injected.get(k, 0)))

    def metrics_snapshot(self) -> dict:
        """JSON-able observability snapshot of every registry instrument,
        plus ``quarantine_log``: the quarantined chunk ids in order."""
        snap = self.metrics.snapshot()
        snap["quarantine_log"] = [int(j) for j in self.engine.quarantine_log]
        return snap

    def _decoded_fraction(self) -> float:
        """Parse-once cache coverage of the scan (0.0 without a decoded
        cache)."""
        return float(self.engine.decoded_fraction())

    def close(self) -> None:
        """Release engine resources (the streaming prefetcher's reader
        thread); idempotent, a no-op under packed residency."""
        self.engine.close()

    def __enter__(self) -> "OLAWorkloadServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- clock ----
    @property
    def t_model(self) -> float:
        """Modeled seconds since server start (Eq. 4 clock + idle skips)."""
        return max(float(self.state.t_io), float(self.state.t_cpu)) \
            + self.idle_offset

    @property
    def tuples_scanned(self) -> int:
        """Raw tuples the shared scan has extracted (workload total)."""
        return int(self.state.scan_m.sum())

    # -------------------------------------------------- fault tolerance ----
    def _pipeline_retries(self) -> int:
        """Cumulative retried chunk reads (streaming; 0 packed)."""
        pf = self.engine.pipeline
        return int(pf.read_retries) if pf is not None else 0

    @property
    def chunks_quarantined(self) -> int:
        return self._quarantine_count

    def quarantine(self, chunk_ids) -> None:
        """Quarantine chunks by hand (operator escape hatch, tests): the
        path round_data takes when a read exhausts its retries."""
        before = int(self.state.quarantined.sum())
        self.state = quarantine_chunks(self.state, chunk_ids)
        if int(self.state.quarantined.sum()) == before:
            return
        log = self.engine.quarantine_log
        known = set(int(j) for j in log)
        qn = self.state.quarantined.cpu().numpy()
        log.extend(sorted(int(j) for j in np.flatnonzero(qn)
                          if int(j) not in known))
        self._note_quarantine(force=True)

    def _note_quarantine(self, force: bool = False) -> None:
        """Absorb newly quarantined chunks into every population-priced
        structure: resident queries' explain records, the decoded cache,
        the synopsis, and the scan rate and admission totals, re-priced
        over the survivors.  A round with nothing new costs one
        list-length check."""
        log = self.engine.quarantine_log
        if len(log) <= self._quarantine_seen and not force:
            return
        new = [int(j) for j in log[self._quarantine_seen:]]
        self._quarantine_seen = len(log)
        if new:
            for w in self.slot_wq:
                if w is not None and w.explain is not None:
                    w.explain.record_degradation(
                        round=self.rounds, t=self.t_model, chunk_ids=new)
            if self.tracer.enabled:
                self.tracer.event("quarantine", chunks=len(new))
        qn = self.state.quarantined.cpu().numpy()
        self._quarantine_count = int(qn.sum())
        sizes = np.asarray(self.store.chunk_sizes)
        alive = ~qn
        self._eff_chunks = int(alive.sum())
        self._eff_tuples = int(sizes[alive].sum())
        self._eff_bytes = (float(sizes[alive].sum())
                           * self.store.codec.record_bytes)
        # quarantined chunks leave the decoded cache too (their bytes are
        # no longer trusted); the CPU discount re-prices over the rest
        if new:
            self.engine.drop_decoded_chunks(new)
        self._scan_rate = scan_tuples_per_s(
            self.store, self.config, rates=self.rates,
            total_bytes=self._eff_bytes, total_tuples=self._eff_tuples,
            decoded_fraction=self._decoded_fraction())
        if self.synopsis is not None and new:
            self.synopsis.drop_chunks(new)

    def _mask_quarantined_seed(self, seed: Optional[dict]) -> Optional[dict]:
        """Zero a seed row's quarantined columns: the synopsis re-absorbs
        the engine's extraction cache, which may still hold windows of a
        chunk quarantined after it was read."""
        if seed is None or self._quarantine_count == 0:
            return seed
        alive = ~self.state.quarantined.cpu().numpy()
        return dict(
            m=np.where(alive, np.asarray(seed["m"]), 0),
            ysum=np.where(alive, np.asarray(seed["ysum"]), 0.0),
            ysq=np.where(alive, np.asarray(seed["ysq"]), 0.0),
            psum=np.where(alive, np.asarray(seed["psum"]), 0.0))

    def _fault_fields(self, s: int) -> dict:
        """The degraded-answer fields of a result retiring from slot ``s``."""
        return dict(degraded=self._quarantine_count > 0,
                    chunks_quarantined=self._quarantine_count,
                    read_retries=max(self._pipeline_retries()
                                     - int(self._slot_retries0[s]), 0))

    # ------------------------------------------------------------ intake ----
    def submit(self, query: Query, arrival_t: Optional[float] = None,
               plan: Optional[str] = None) -> int:
        """Enqueue a query; returns its qid.  ``arrival_t`` defaults to the
        current modeled time.  Raises at submit time when the query is
        outside the slot-encodable linear+range form, the plan is unknown,
        or the scan is fully extracted with no synopsis to answer from."""
        if plan is not None and plan not in PLAN_CODES:
            raise ValueError(
                f"unknown plan {plan!r}; expected one of {sorted(PLAN_CODES)}")
        if query.group_by is not None and self.max_groups == 0:
            raise ValueError(
                f"query {query.name!r} has group_by but the server was built "
                f"ungrouped; construct it with EngineConfig(max_groups="
                f"{query.group_by.max_groups}) or higher")
        row = encode_slot(query, self.store.codec.num_cols,
                          max_groups=self.max_groups)  # validates early
        if self.synopsis is None and not (
                (self.state.scan_m.cpu().numpy()
                 < np.asarray(self.store.chunk_sizes))
                & ~self.state.quarantined.cpu().numpy()).any():
            raise ValueError(
                "scan fully extracted and no synopsis configured: the query "
                "can never be served; construct the server with "
                "synopsis_budget_tuples > 0")
        qid = self._next_qid
        self._next_qid += 1
        at = self.t_model if arrival_t is None else float(arrival_t)
        wq = WorkloadQuery(qid=qid, query=query, arrival_t=at, plan=plan,
                           row=row, explain=ExplainRecord(
                               qid=qid, name=query.name, t_submit=at))
        self.queue.append(wq)
        self.queue.sort(key=lambda wq: (wq.arrival_t, wq.qid))
        if self.tracer.enabled:
            self.tracer.event("submit", qid=qid, query=query.name)
        return qid

    # --------------------------------------------------------- admission ----
    def _free_slots(self) -> list[int]:
        return [s for s in range(self.max_slots) if self.slot_wq[s] is None]

    def _refresh_synopsis(self) -> None:
        """Absorb the scan's extraction cache into the synopsis (on demand,
        before seeding a newcomer)."""
        if self.synopsis is None or self.tuples_scanned == 0:
            return
        variances = self.synopsis.within_variances(self.state)
        self.synopsis.update_from_engine(
            self.state, self.state.schedule.cpu().numpy(), variances)

    def _admit_ready(self) -> None:
        now = self.t_model
        while self.queue and self.queue[0].arrival_t <= now:
            free = self._free_slots()   # recompute: seed-answered slots refree
            if not free:
                for wq in self.queue:   # ready queries kept waiting: record it
                    if wq.arrival_t <= now:
                        wq.queued = True
                break
            wq = self.queue.pop(0)
            self._admit(free[0], wq)

    def _finish(self, wq: WorkloadQuery, result: WorkloadResult) -> None:
        """Single retirement funnel: finalize the explain record, count the
        outcome, observe latency, emit the retire trace event."""
        if wq.explain is not None:
            result.explain = wq.explain.finalize(result)
        self.results.append(result)
        self.metrics.counter(
            "queries_total", help="completed queries by scheduler outcome",
            labels={"outcome": result.sched_outcome}).inc()
        self.metrics.histogram(
            "query_latency_s", help="submit->done latency (modeled s)",
            bounds=LATENCY_BUCKETS_S).observe(result.latency)
        if self.tracer.enabled:
            self.tracer.event("retire", qid=result.qid,
                              outcome=result.sched_outcome,
                              rounds=result.rounds_resident)

    def _admit(self, s: int, wq: WorkloadQuery) -> None:
        df = self._decoded_fraction()
        plan = wq.plan or select_plan(self.store, self.config, wq.query,
                                      rates=self.rates, decoded_fraction=df)
        row = wq.row or encode_slot(wq.query, self.store.codec.num_cols,
                                    max_groups=self.max_groups)
        row["plan"] = np.int32(PLAN_CODES[plan])
        self._refresh_synopsis()
        seed = self._mask_quarantined_seed(
            self.synopsis.seed_slot(wq.query) if self.synopsis else None)
        stats, seeded = slot_stats_write(self.state.stats, s, seed,
                                         self.store.num_chunks)
        stopped = self.state.stopped.clone()
        stopped[s] = False
        self.state = self.state._replace(stats=stats, stopped=stopped)
        self.table = slot_table_set(self.table, s, row)
        self._weights[s] = np.float32(row.get("weight", 1.0))
        self.slot_wq[s] = wq
        self.slot_admit_t[s] = self.t_model
        self.slot_admit_round[s] = self.rounds
        self.slot_plan[s] = plan
        self.slot_seeded[s] = seeded
        self._slot_retries0[s] = self._pipeline_retries()
        gb = wq.query.group_by
        if gb is not None:
            # a new occupant starts with empty cells (a previous grouped
            # resident may have left rows behind); pinned values are live
            # from the row write, the rest are discovered
            self.state = zero_group_cells(self.state, s)
            self._slot_sketch[s] = GroupSketch(max(2 * gb.max_groups, 8))
            self._slot_groups[s] = [float(v) for v in (gb.values or ())]
        if wq.explain is not None:
            # the Eq. (4) pricing the plan was chosen under (population-
            # adjusted, decoded-cache-discounted)
            t_io, t_cpu = eq4_cost_terms(
                self.store, self.config, self.rates,
                total_bytes=self._eff_bytes, total_tuples=self._eff_tuples,
                decoded_fraction=df)
            wq.explain.plan = plan
            wq.explain.cost_t_io_s = float(t_io)
            wq.explain.cost_t_cpu_s = float(t_cpu)
            wq.explain.decoded_fraction = float(df)
            wq.explain.effective_epsilon = float(
                row.get("eps", wq.query.epsilon))
            if not wq.explain.admission_reason:
                wq.explain.admission_reason = "fifo: free slot"
        if self.tracer.enabled:
            self.tracer.event("admit", qid=wq.qid, slot=s, plan=plan)
        # Section 6.3 best case, per slot: the seed alone may already meet
        # the target — answer at admission without consuming scan rounds
        if seed is not None:
            self._try_retire_from_seed(s, wq)

    def _try_retire_from_seed(self, s: int, wq: WorkloadQuery) -> bool:
        q = wq.query
        if q.group_by is not None:
            # a seed meets the scalar target at best; the group cells fill
            # only from scan rounds, so a grouped query always scans
            return False
        st = self.state.stats
        stats_row = st._replace(
            m=st.m[s], ysum=st.ysum[s][None], ysq=st.ysq[s][None],
            psum=st.psum[s][None],
            n_total=self._eff_chunks, m_total=self._eff_tuples)
        est_v, lo, hi, err = (t.cpu().numpy() for t in
                              _answer_from_stats([q], stats_row))
        e = float(err[0])
        decision = -1
        if q.having is not None:
            decision = int(est.having_decision(lo[0], hi[0], q.having.op,
                                               q.having.threshold))
        if e > q.epsilon and decision == -1:
            return False
        if wq.explain is not None and not wq.explain.tier_reason:
            wq.explain.tier_reason = ("seed met the target at admission "
                                      "(answered without scan rounds)")
        self._finish(wq, WorkloadResult(
            qid=wq.qid, name=q.name, estimate=float(est_v[0]),
            lo=float(lo[0]), hi=float(hi[0]), err=e,
            decision=decision, plan=self.slot_plan[s],
            t_submit=wq.arrival_t, t_admit=self.slot_admit_t[s],
            t_done=self.t_model, seeded_tuples=int(self.slot_seeded[s]),
            tuples_seen=int(st.m[s].sum()),
            rounds_resident=0, from_synopsis=True,
            sched_outcome="queued" if wq.queued else "admitted",
            queue_wait=self.slot_admit_t[s] - wq.arrival_t,
            **self._fault_fields(s)))
        self._release(s)
        return True

    def _release(self, s: int) -> None:
        self.table = slot_table_clear(self.table, s)
        stopped = self.state.stopped.clone()
        stopped[s] = True
        self.state = self.state._replace(stopped=stopped)
        self.slot_wq[s] = None
        self._slot_sketch[s] = None
        self._slot_groups[s] = None

    # ---------------------------------------------------------- grouping ----
    def _group_results(self, rep, s: int,
                       wq: WorkloadQuery) -> Optional[list[GroupResult]]:
        """Slot ``s``'s grouped answer from the round report: one
        :class:`GroupResult` per tracked value (discovery order) and the
        ``__other__`` spill.  HAVING is judged per cell, host-side, on the
        report's CI."""
        q = wq.query
        if q.group_by is None:
            return None
        tracked = self._slot_groups[s] or []
        g_est, g_lo, g_hi, g_err = (t[s].cpu().numpy().astype(float) for t in
                                    (rep.g_est, rep.g_lo, rep.g_hi, rep.g_err))
        g_n = rep.g_n[s].cpu().numpy()
        cells = [(i, float(v), False) for i, v in enumerate(tracked)]
        cells.append((self.max_groups, float("nan"), True))
        out = []
        for i, value, is_other in cells:
            decision = -1
            if q.having is not None and int(g_n[i]) > 0:
                decision = int(est.having_decision(
                    float(g_lo[i]), float(g_hi[i]), q.having.op,
                    q.having.threshold))
            out.append(GroupResult(
                value=value, estimate=float(g_est[i]), lo=float(g_lo[i]),
                hi=float(g_hi[i]), err=float(g_err[i]), n=int(g_n[i]),
                decision=decision, is_other=is_other))
        return out

    def _fold_group_discovery(self, rep) -> None:
        """After a round, for every live grouped slot: fold the round's
        tallies into its sketch, promote newly heavy values into free cells
        (grow-only), and restart the ``__other__`` cell whenever the tracked
        set grows (the spill's meaning shrank).  The tallies are read to the
        host once a round, when a grouped slot is live."""
        if self.max_groups == 0:
            return
        g_tal = None
        stopped = self.state.stopped.cpu().numpy()
        for s in range(self.max_slots):
            wq = self.slot_wq[s]
            if (wq is None or stopped[s] or wq.query.group_by is None
                    or self._slot_sketch[s] is None):
                continue
            if g_tal is None:
                g_tal = rep.g_tal.cpu().numpy()
            sketch = self._slot_sketch[s]
            sketch.fold(g_tal[s])
            if sketch.mass < self._group_warmup:
                continue    # the ranking is not trustworthy yet
            gb = wq.query.group_by
            tracked = self._slot_groups[s]
            new = promote_values(sketch, tracked, gb.max_groups)
            if not new:
                continue
            tracked.extend(float(v) for v in new)
            g = self.max_groups + 1
            gval = np.zeros((g,), np.float32)
            gact = np.zeros((g,), np.float32)
            gval[:len(tracked)] = np.asarray(tracked, np.float32)
            gact[:len(tracked)] = 1.0
            gact[g - 1] = 1.0   # __other__ stays live
            self.table = slot_table_set_groups(self.table, s, gval, gact)
            self.state = zero_group_cells(self.state, s, cells=[g - 1])
            if self.tracer.enabled:
                self.tracer.event("group_promote", qid=wq.qid, slot=s,
                                  values=[float(v) for v in new])

    # ----------------------------------------------------------- top-up ----
    def _begin_topup_pass(self) -> bool:
        """Re-open early-closed chunks and rewind the schedule head to the
        first not-closed position.  Worker claims drop to IDLE so
        re-claiming is race-free; a re-opened chunk is charged as a fresh
        raw READ when extraction resumes; per-chunk permutation cursors
        continue.  Returns False when every chunk is fully extracted."""
        dev = self.device
        sizes = np.asarray(self.store.chunk_sizes)
        scan_m = self.state.scan_m.cpu().numpy()
        quarantined = self.state.quarantined.cpu().numpy()
        not_exhausted = (scan_m < sizes) & ~quarantined
        if not not_exhausted.any():
            return False
        closed_now = self.state.closed.cpu().numpy()
        reopened = closed_now & not_exhausted
        closed = closed_now & ~not_exhausted
        schedule = self.state.schedule.cpu().numpy()
        done_sched = closed[schedule]
        new_head = (len(schedule) if done_sched.all()
                    else int(np.argmax(~done_sched)))
        raw_touched = self.state.raw_touched.cpu().numpy() & ~reopened
        self.state = self.state._replace(
            closed=torch.as_tensor(closed, device=dev),
            head=torch.tensor(new_head, dtype=torch.int32, device=dev),
            cur=torch.full_like(self.state.cur, IDLE),
            raw_touched=torch.as_tensor(raw_touched, device=dev))
        self.topup_passes += 1
        return True

    # -------------------------------------------------------------- step ----
    def _retire_finished(self, rep, unserved: frozenset = frozenset()) -> None:
        stopped = self.state.stopped.cpu().numpy()
        if not any(self.slot_wq[s] is not None and stopped[s]
                   for s in range(self.max_slots)):
            return
        m_rows = self.state.stats.m.cpu().numpy()
        est_a, lo_a, hi_a, err_a, dec_a = (
            t.cpu().numpy() for t in (rep.estimate, rep.lo, rep.hi, rep.err,
                                      rep.decided))
        for s in range(self.max_slots):
            wq = self.slot_wq[s]
            if wq is None or not stopped[s]:
                continue
            # a slot that never received a tuple has no answer: unserved
            bad = s in unserved or int(m_rows[s].sum()) == 0
            if wq.explain is not None and not wq.explain.tier_reason:
                wq.explain.tier_reason = (
                    "scan exhausted before the slot saw any tuple" if bad
                    else "scan-served: retired at its stop condition")
            self._finish(wq, WorkloadResult(
                qid=wq.qid, name=wq.query.name,
                estimate=float("nan") if bad else float(est_a[s]),
                lo=float(lo_a[s]), hi=float(hi_a[s]), err=float(err_a[s]),
                decision=int(dec_a[s]), plan=self.slot_plan[s],
                t_submit=wq.arrival_t, t_admit=self.slot_admit_t[s],
                t_done=self.t_model, seeded_tuples=int(self.slot_seeded[s]),
                tuples_seen=int(m_rows[s].sum()),
                rounds_resident=int(self.rounds - self.slot_admit_round[s]),
                unserved=bad,
                sched_outcome="queued" if wq.queued else "admitted",
                queue_wait=float(self.slot_admit_t[s] - wq.arrival_t),
                groups=None if bad else self._group_results(rep, s, wq),
                **self._fault_fields(s)))
            self._release(s)

    def _any_active(self) -> bool:
        return any(wq is not None for wq in self.slot_wq)

    def _record_trajectory(self, rep, b) -> None:
        """Append this round's ``(m, est, ci_halfwidth, b_eff, weight)`` point
        to every resident query's explain record."""
        live = [(s, self.slot_wq[s]) for s in range(self.max_slots)
                if self.slot_wq[s] is not None
                and self.slot_wq[s].explain is not None]
        if not live:
            return
        est_a = rep.estimate.cpu().numpy().astype(float)
        lo = rep.lo.cpu().numpy().astype(float)
        hi = rep.hi.cpu().numpy().astype(float)
        m_rows = self.state.stats.m.sum(dim=1).cpu().numpy()
        g_est = g_lo = g_hi = None
        for s, wq in live:
            w = float(self._weights[s])
            groups = None
            if wq.query.group_by is not None:
                if g_est is None:
                    g_est, g_lo, g_hi = (t.cpu().numpy().astype(float) for t
                                         in (rep.g_est, rep.g_lo, rep.g_hi))
                tracked = self._slot_groups[s] or []
                idx = list(range(len(tracked))) + [self.max_groups]
                vals = [float(v) for v in tracked] + [float("nan")]
                groups = tuple(
                    (v, float(g_est[s, i]),
                     float((g_hi[s, i] - g_lo[s, i]) / 2.0))
                    for v, i in zip(vals, idx))
            wq.explain.record_round(RoundSample(
                round=self.rounds, m=int(m_rows[s]), est=float(est_a[s]),
                ci_halfwidth=float((hi[s] - lo[s]) / 2.0),
                b_eff=int(round(float(b) * w)), weight=w, groups=groups))

    def step(self) -> bool:
        """Admit ready arrivals, run one engine round, retire finished
        queries.  Returns False when there is nothing to do right now."""
        tr = self.tracer
        self._admit_ready()
        if not self._any_active():
            return False
        with tr.span("round", round=self.rounds):
            b = self.engine.budget_ladder(float(self.state.budget))
            with tr.span("claims"):
                self.state, data = self.engine.round_data(self.state)
            # a failed read may have quarantined chunks inside round_data:
            # fold the survivors into every population-priced structure
            # before the round estimates over them
            self._note_quarantine()
            mode, data = self.engine.data_mode(data)
            with tr.span("kernel", b=b, mode=mode):
                self.state, rep = self.engine.round_fn(b, mode)(
                    self.state, self.table, data, self.engine.speeds)
            self.rounds += 1
            with tr.span("estimate"):
                self._record_trajectory(rep, b)
                self._retire_finished(rep)
                self._fold_group_discovery(rep)
                if self._any_active() and bool(rep.exhausted):
                    if not self._begin_topup_pass():
                        # census complete: estimates are as good as they get
                        self._force_retire_exhausted(rep)
        return True

    def _force_retire_exhausted(self, rep) -> None:
        """Every chunk is fully extracted: retire the survivors with their
        final estimates.  A slot that never received a tuple is flagged
        ``unserved`` with a NaN estimate."""
        m = self.state.stats.m.cpu().numpy()
        unserved = frozenset(
            s for s in range(self.max_slots)
            if self.slot_wq[s] is not None and int(m[s].sum()) == 0)
        self.state = self.state._replace(
            stopped=torch.ones_like(self.state.stopped))
        self._retire_finished(rep, unserved=unserved)

    # --------------------------------------------------------------- run ----
    def run(self, max_rounds: int = 200_000, wall_timeout_s: float = 600.0,
            on_round=None) -> list[WorkloadResult]:
        """Drive until the queue drains and every resident query retires.

        If ``max_rounds`` or ``wall_timeout_s`` cuts the loop short,
        ``self.truncated`` is set and the returned list misses the
        unfinished queries.  ``on_round(server)`` is called after every
        engine round."""
        self.truncated = False
        t0 = time.perf_counter()
        while self.queue or self._any_active():
            if self.rounds >= max_rounds:
                self.truncated = True
                break
            if time.perf_counter() - t0 > wall_timeout_s:
                self.truncated = True
                break
            stepped = self.step()
            if stepped and on_round is not None:
                on_round(self)
            if not stepped:
                if not self.queue:
                    break
                # idle: jump the modeled clock to the next arrival
                nxt = self.queue[0].arrival_t
                if nxt > self.t_model:
                    self.idle_offset += nxt - self.t_model
        self.results.sort(key=lambda r: r.qid)
        return self.results


def poisson_workload(queries: Sequence[Query], rate_per_model_s: float,
                     seed: int = 0,
                     rng: Optional[np.random.Generator] = None,
                     ) -> list[tuple[Query, float]]:
    """Poisson arrival process over a fixed query list: ``(query,
    arrival_t)`` pairs with exponential inter-arrivals at
    ``rate_per_model_s`` per modeled second.  The same ``seed`` always
    yields the same arrivals; an explicit ``rng`` overrides it."""
    if rng is None:
        rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for q in queries:
        t += float(rng.exponential(1.0 / rate_per_model_s))
        out.append((q, t))
    return out
