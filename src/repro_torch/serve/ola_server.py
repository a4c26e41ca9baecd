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

* **SLO scheduling** — with ``ServerOptions(scheduler=...)`` queries carry
  a :class:`~repro_torch.sched.slo.QuerySLO`; ready queries are admitted,
  queued, shed or given a preempted slot in priority order, each round's
  evaluation budget is divided by weighted max-min fairness, the
  schedule's unclaimed tail is claimed by variance, and deadlines are
  enforced (:mod:`repro_torch.sched`);
* **rollup answers** — with ``ServerOptions(rollup=...)`` hot query patterns
  are promoted to cells maintained from the scan's per-chunk statistics,
  and repeats are answered from them with no slot and no scan round
  (:mod:`repro_torch.serve.rollup`).

The server runs on one device, with packed or streaming residency
(``EngineConfig.residency``; the decoded-chunk cache with
``decoded_cache_bytes``), or over the ranks of a mesh
(``ServerOptions(mesh=...)``: :class:`~repro_torch.core.engine_spmd.
SlotSPMDEngine`, the server running identically on every rank), or around
an engine the caller built (``ServerOptions(engine=...)``).  A chunk whose
reads fail for good is quarantined: the answers of every query live at or
after that moment describe the surviving population and are flagged
``degraded``.  The scheduler's decisions read the modeled clock (Eq. (4)
time, never wall time) and price their previews on the host.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
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
    slot_group_rows,
    slot_stats_fold,
    slot_stats_snapshot,
    slot_stats_write,
    zero_group_cells,
)
from repro_torch.core.engine_spmd import SlotSPMDEngine
from repro_torch.core.estimators import BiLevelStats
from repro_torch.core.groupby import GroupSketch, promote_values
from repro_torch.core.queries import (
    PLAN_CODES,
    GroupResult,
    Query,
    empty_slot_table,
    encode_slot,
    group_fanout,
    slot_table_clear,
    slot_table_set,
    slot_table_set_groups,
)
from repro_torch.core.synopsis import BiLevelSynopsis
from repro_torch.device import resolve_device
from repro_torch.obs.explain import ExplainRecord, RoundSample
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sched.admission import (
    SHED,
    TIER1,
    ServerLoad,
    eq4_cost_terms,
    scan_tuples_per_s,
)
from repro_torch.sched.preempt import select_victim
from repro_torch.sched.scheduler import SchedulerConfig, WorkloadScheduler
from repro_torch.sched.slo import NO_SLO, QuerySLO
from repro_torch.serve.rollup import RollupConfig, RollupTier, pattern_key

#: the calibration file this package's slot-kernel benchmark writes at the
#: repo root; until that benchmark has run, the modeled constants price
#: the scan
RATES_FILE = "BENCH_torch_slot_kernel.json"


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
    # linear fit of the calibration's slot sweep, round_us(S) = base +
    # slot_us·S: the scan-side round cost and the marginal cost of one
    # fully counted slot (the scheduler's measured slot capacity; 0 = no
    # fit)
    round_base_us: float = 0.0
    round_slot_us: float = 0.0


def default_rates_path() -> str:
    """Where :func:`load_measured_rates` looks by default: ``$OLA_RATES_PATH``
    when set, else this package's calibration file at the repo root
    (:data:`RATES_FILE`), anchored to the source tree and not the working
    directory; outside a source checkout, the file in the working
    directory."""
    env = os.environ.get("OLA_RATES_PATH")
    if env:
        return env
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    if os.path.isdir(os.path.join(repo_root, "benchmarks")):
        return os.path.join(repo_root, RATES_FILE)
    return RATES_FILE


def load_measured_rates(path: Optional[str] = None,
                        ) -> Optional[MeasuredRates]:
    """The ``calibration`` block of a slot-kernel benchmark result file as
    :class:`MeasuredRates`; ``path=None`` resolves through
    :func:`default_rates_path`.  ``None`` (the caller keeps the modeled
    constants) when the file is missing or holds no usable calibration:
    rates must be finite and positive, and a NaN or non-positive round-cost
    fit reads as no fit."""
    if path is None:
        path = default_rates_path()
    try:
        with open(path) as f:
            data = json.load(f)
        cal = data["calibration"]
        cost = float(cal.get("cost_per_tuple", 0.0))

        def _opt(key):
            v = float(cal.get(key, 0.0))
            return v if math.isfinite(v) and v > 0 else 0.0

        rates = MeasuredRates(
            io_bytes_per_sec=float(cal["io_bytes_per_sec"]),
            cpu_tuples_per_sec=float(cal["cpu_tuples_per_sec"]),
            workers=int(cal.get("workers", data.get("workers", 1))),
            source=f"{path}:{cal.get('backend', '?')}",
            cost_per_tuple=cost if math.isfinite(cost) and cost > 0 else 0.0,
            round_base_us=_opt("round_base_us"),
            round_slot_us=_opt("round_slot_us"))
        # json.load accepts NaN, which compares False to everything
        if not all(math.isfinite(v) and v > 0 for v in
                   (rates.io_bytes_per_sec, rates.cpu_tuples_per_sec,
                    rates.workers)):
            return None
        return rates
    except (OSError, KeyError, TypeError, ValueError):
        return None


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

    ``scheduler`` takes a :class:`~repro_torch.sched.WorkloadScheduler` or a
    :class:`~repro_torch.sched.SchedulerConfig`; ``rollup`` a
    :class:`~repro_torch.serve.rollup.RollupConfig` or a built
    :class:`~repro_torch.serve.rollup.RollupTier`.  ``measured_rates`` (or
    a ``rates_path`` calibration file, :func:`load_measured_rates`) price
    the scan on measured rates instead of the modeled constants.  ``mesh``
    (a ``DeviceMesh`` with a ``"data"`` dimension) runs the scan on :class:`~repro_torch.core.engine_spmd.SlotSPMDEngine`
    over its ranks; ``engine`` serves on an engine the caller built over
    the same store (its config and slot count win over the options')."""

    max_slots: int = 8
    synopsis_budget_tuples: int = 4096
    confidence: float = 0.95
    schedule: Optional[np.ndarray] = None
    measured_rates: Optional[MeasuredRates] = None
    rates_path: Optional[str] = None
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


_legacy_kwargs_warned = False


def _options_from_legacy(kwargs: dict) -> ServerOptions:
    """Map the constructor's keyword surface onto :class:`ServerOptions`,
    warning once per process; unknown names raise ``TypeError``."""
    global _legacy_kwargs_warned
    names = {f.name for f in dataclasses.fields(ServerOptions)}
    unknown = sorted(set(kwargs) - names)
    if unknown:
        raise TypeError(
            f"OLAWorkloadServer got unexpected keyword argument(s) {unknown}; "
            f"valid ServerOptions fields: {sorted(names)}")
    if not _legacy_kwargs_warned:
        warnings.warn(
            "passing OLAWorkloadServer construction keywords directly is "
            "deprecated; use OLAWorkloadServer(store, config, "
            "options=ServerOptions(...))",
            DeprecationWarning, stacklevel=3)
        _legacy_kwargs_warned = True
    return ServerOptions(**kwargs)


@dataclasses.dataclass
class WorkloadQuery:
    """One submitted query: the aggregate plus its workload metadata."""

    qid: int
    query: Query
    arrival_t: float = 0.0          # modeled seconds on the server clock
    plan: Optional[str] = None      # None -> cost-model selector
    row: Optional[dict] = None      # slot row encoded (and validated) at submit
    slo: Optional[QuerySLO] = None  # service-level objective (scheduler)
    queued: bool = False            # waited >= one admission pass for a slot
    preempted: bool = False         # evicted mid-residence at least once
    saved_stats: Optional[dict] = None  # eviction snapshot: re-admission seed
    key: Optional[tuple] = None     # rollup pattern key (None: not cacheable,
                                    # or the server has no rollup tier)
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
    # "admitted" (straight into a slot), "queued" (waited for one),
    # "preempted" (evicted mid-residence, re-queued and completed), "shed"
    # (never held a slot: a best-effort synopsis answer, or unserved) or
    # "tier1" (answered from the rollup cache, plan="rollup")
    sched_outcome: str = "admitted"
    queue_wait: float = 0.0         # t_admit - t_submit (modeled s)
    slo_met: Optional[bool] = None  # None when the query carried no SLO
    priority: str = "normal"        # the SLO's priority class
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

    A host-side loop around :class:`SlotOLAEngine` (:class:`SlotSPMDEngine`
    under a mesh): ``submit`` enqueues, ``step`` runs one engine round
    (admitting and retiring between rounds), ``run`` drives to completion.
    The modeled clock is Eq. (4)'s overlapped-pipeline time ``max(t_io,
    t_cpu)`` plus the idle gaps the server skips while waiting for
    arrivals.  The engine, and so the packed store, lives on ``device`` —
    the CUDA device unless the caller names another (an injected engine's
    own device); without one the constructor raises.  Under a mesh every
    rank runs the same server on the same submissions: its decisions read
    replicated state and the modeled clock, so the ranks stay in step.
    """

    def __init__(self, store, config: EngineConfig,
                 options: Optional[ServerOptions] = None, device=None,
                 **legacy_kwargs):
        """``options`` collects every construction knob; the former keyword
        surface (``max_slots=...`` and the other :class:`ServerOptions`
        fields as keywords) still works but warns once per process."""
        if legacy_kwargs:
            if options is not None:
                raise TypeError(
                    "pass either options=ServerOptions(...) or the legacy "
                    "keyword arguments, not both")
            options = _options_from_legacy(legacy_kwargs)
        opts = options if options is not None else ServerOptions()
        max_slots = opts.max_slots
        engine = opts.engine
        if engine is not None:
            if engine.store is not store:
                raise ValueError("engine was built over a different store")
            if (opts.synopsis_budget_tuples > 0
                    and engine.config.cache_cap == 0):
                raise ValueError(
                    "mid-scan synopsis seeding needs the extraction cache: "
                    "build the engine with cache_cap > 0 or pass "
                    "synopsis_budget_tuples=0")
            if device is not None and (torch.device(device)
                                       != engine.device):
                raise ValueError(f"the engine lives on {engine.device}, "
                                 f"not {device}")
            config = engine.config
            max_slots = engine.max_slots
            self.device = engine.device
        else:
            self.device = resolve_device(device)
            if config.cache_cap == 0 and opts.synopsis_budget_tuples > 0:
                # mid-scan seeding needs the extraction cache
                cap = max(64, int(np.ceil(4 * opts.synopsis_budget_tuples
                                          / max(store.num_chunks, 1))))
                config = dataclasses.replace(config, cache_cap=cap)
        self.store = store
        self.config = config
        if engine is not None:
            self.engine = engine
        elif opts.mesh is not None:
            self.engine = SlotSPMDEngine(store, max_slots, config, opts.mesh,
                                         schedule=opts.schedule,
                                         confidence=opts.confidence,
                                         device=self.device)
        else:
            self.engine = SlotOLAEngine(store, max_slots, config,
                                        schedule=opts.schedule,
                                        confidence=opts.confidence,
                                        device=self.device)
        self.rates = opts.measured_rates
        if self.rates is None and opts.rates_path is not None:
            self.rates = load_measured_rates(opts.rates_path)
        # the table's group capacity follows the engine's (0: ungrouped)
        self.max_groups = int(self.config.max_groups)
        self.table = empty_slot_table(max_slots, store.codec.num_cols,
                                      self.max_groups, device=self.device)
        self.state = self.engine.init_state()
        # chunk sizes on the host: admission previews are priced there
        self._sizes_host = self.state.stats.M.cpu()
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
        # host mirrors of the slot table's weight and eps columns (what the
        # server last wrote), so the per-round hooks read no device state
        self._weights = np.ones(max_slots, np.float32)
        self._slot_eps = np.ones(max_slots, np.float32)
        scheduler, rollup = opts.scheduler, opts.rollup
        if isinstance(scheduler, SchedulerConfig):
            scheduler = WorkloadScheduler(scheduler)
        self.scheduler: Optional[WorkloadScheduler] = scheduler
        if self.scheduler is not None:
            # slot_capacity="measured" follows the calibration's fit
            self.scheduler.calibrate(self.rates)
        if isinstance(rollup, RollupConfig):
            rollup = RollupTier(store, rollup)
        self.rollup: Optional[RollupTier] = rollup
        if self.rollup is not None and self.rollup.store is not store:
            raise ValueError("rollup tier was built over a different store")
        self.shed_count = 0
        self.preempt_count = 0
        self._service_times: list[float] = []   # scan service per retirement
        self._preview_cache: dict[int, tuple] = {}  # per intake pass, by qid
        self._rollup_cache: dict[int, tuple] = {}   # per intake pass, by qid
        self._last_err: Optional[np.ndarray] = None  # (S,) last round report
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
        export time, no hot-path writes), with the prefetcher's, the rollup
        tier's and the scheduler's."""
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
        reg.gauge("server_shed_count", help="queries shed (best-effort)",
                  fn=lambda: self.shed_count)
        reg.gauge("server_preempt_count", help="slot evictions",
                  fn=lambda: self.preempt_count)
        reg.gauge("server_chunks_quarantined",
                  help="chunks removed from the population",
                  fn=lambda: self._quarantine_count)
        reg.gauge("server_quarantine_events",
                  help="engine quarantine_log length",
                  fn=lambda: len(self.engine.quarantine_log))
        if self.engine.pipeline is not None:
            self.engine.pipeline.bind_metrics(reg)
        if self.rollup is not None:
            self.rollup.bind_metrics(reg)
        if self.scheduler is not None:
            self.scheduler.bind_metrics(reg)
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
        the synopsis, the rollup cells covering them, and the scan rate and
        admission totals, re-priced over the survivors.  A round with nothing new costs one
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
        if self.rollup is not None and new:
            self.rollup.invalidate_chunks(new)

    def _mask_quarantined_seed(self, seed: Optional[dict]) -> Optional[dict]:
        """Zero a seed row's quarantined columns: the synopsis re-absorbs
        the engine's extraction cache, which may still hold windows of a
        chunk quarantined after it was read, and preemption snapshots may
        predate the quarantine.  Every seed goes through here: admission,
        the scheduled intake's previews and a promoted rollup cell's birth
        seed."""
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
               plan: Optional[str] = None,
               slo: Optional[QuerySLO] = None) -> int:
        """Enqueue a query; returns its qid.  ``arrival_t`` defaults to the
        current modeled time.  ``slo`` attaches a service-level objective
        (deadline, CI half-width target, priority class); it takes effect
        when the server has a scheduler.  Raises at submit time when the
        query is outside the slot-encodable linear+range form, the plan is
        unknown, or the scan is fully extracted with no synopsis to answer
        from."""
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
        key = (pattern_key(query, self.store.codec.num_cols)
               if self.rollup is not None else None)
        wq = WorkloadQuery(qid=qid, query=query, arrival_t=at, plan=plan,
                           row=row, slo=slo, key=key,
                           explain=ExplainRecord(qid=qid, name=query.name,
                                                 t_submit=at))
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
        if self.rollup is not None:
            self.rollup.maintain(self.t_model)
            self._rollup_cache = {}
        if self.scheduler is not None:
            self._admit_ready_scheduled()
            return
        now = self.t_model
        if self.rollup is not None:
            # a Tier-1 answer needs no slot: every ready hit is answered
            # now, even with the slot table full and behind other work
            for wq in [w for w in self.queue if w.arrival_t <= now]:
                if self._try_tier1(wq):
                    self.queue.remove(wq)
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

    @staticmethod
    def _wants_preview(wq: WorkloadQuery) -> bool:
        slo = wq.slo or NO_SLO
        return slo.has_deadline or np.isfinite(slo.target_halfwidth)

    @staticmethod
    def _outcome(wq: WorkloadQuery) -> str:
        if wq.preempted:
            return "preempted"
        return "queued" if wq.queued else "admitted"

    def _admit_ready_scheduled(self) -> None:
        """Scheduler intake: ready queries in queue-policy order, each
        answered Tier-1, admitted, left queued, shed or, with
        ``config.preempt``, given a slot by evicting a strictly-lower-
        priority resident when its deadline is feasible only that way."""
        sched = self.scheduler
        now = self.t_model
        ready = [wq for wq in self.queue if wq.arrival_t <= now]
        # one synopsis refresh per intake pass; the previews are cached for
        # the pass (feasibility, shedding and _admit's effective ε)
        self._preview_cache = {}
        if self.synopsis is not None and any(map(self._wants_preview, ready)):
            self._refresh_synopsis()
        while True:
            ready = [wq for wq in self.queue if wq.arrival_t <= now]
            ready.sort(key=sched.queue_key)
            ahead: list[WorkloadQuery] = []  # still queued, ahead of this one
            restart = False
            for wq in ready:
                free = self._free_slots()  # recompute: seed-retired slots
                if free and ahead:
                    # a slot freed mid-pass behind queued work (a preempt-
                    # admitted query retired at once from its seed): start
                    # over so the highest-priority queued query claims it
                    restart = True
                    break
                decision = self._decide_admission(wq, len(free), ahead)
                if wq.explain is not None:
                    wq.explain.admission_reason = decision.reason
                    wq.explain.predicted_service_s = \
                        decision.predicted_service_s
                    wq.explain.predicted_finish_t = \
                        decision.predicted_finish_t
                if self.tracer.enabled:
                    self.tracer.event("admission", qid=wq.qid,
                                      action=decision.action)
                if decision.action == TIER1 and self._try_tier1(wq):
                    self.queue.remove(wq)   # no slot taken: no restart
                    continue
                if not free and self._try_preempt(wq, decision):
                    # the victim was evicted so that the deadline fits if
                    # the query runs now: the freed slot is the candidate's
                    self.queue.remove(wq)
                    self._admit(self._free_slots()[0], wq)
                elif decision.action == SHED:
                    self.queue.remove(wq)
                    self._shed(wq)
                elif free:
                    self.queue.remove(wq)
                    self._admit(free[0], wq)
                else:
                    wq.queued = True
                    ahead.append(wq)
            if not restart:
                break
            # a restarted pass sees free slots with nothing ahead, so its
            # head query is admitted or shed: the queue shrinks every time

    def _try_preempt(self, wq: WorkloadQuery, decision) -> bool:
        """Evict a strictly-lower-priority resident for ``wq`` when its
        deadline would die in the queue but fits if the query runs now.
        True when a slot was freed (the victim is snapshotted and
        re-queued)."""
        slo = wq.slo or NO_SLO
        if not (self.scheduler.config.preempt and slo.has_deadline):
            return False
        deadline_t = wq.arrival_t + slo.deadline_s
        if decision.predicted_finish_t <= deadline_t:
            return False                # feasible by waiting
        now = self.t_model
        if max(now, wq.arrival_t) + decision.predicted_service_s > deadline_t:
            return False                # hopeless even with a slot now
        stopped = self.state.stopped.cpu().numpy()
        # grouped residents are never evicted: the snapshot holds only the
        # scalar statistics row, so a re-admitted grouped query would lose
        # its cells and its discovered values
        evictable = [self.slot_wq[s] is not None and not stopped[s]
                     and self.slot_wq[s].query.group_by is None
                     for s in range(self.max_slots)]
        victim = select_victim(
            wq.slo, [w.slo if w is not None else None for w in self.slot_wq],
            self.slot_admit_t, evictable)
        if victim is None:
            return False
        self._evict(victim)
        return True

    def _evict(self, s: int) -> None:
        """Preempt slot ``s``: its statistics row becomes the occupant's
        re-admission seed, the slot is released, and the occupant is
        re-queued flagged ``preempted`` (it completes later)."""
        wq = self.slot_wq[s]
        wq.saved_stats = slot_stats_snapshot(self.state, s)
        wq.preempted = True
        wq.queued = True
        self.preempt_count += 1
        if self.tracer.enabled:
            self.tracer.event("preempt", qid=wq.qid, slot=s)
        self._release(s)
        self.queue.append(wq)
        self.queue.sort(key=lambda w: (w.arrival_t, w.qid))

    def _cached_preview(self, wq: WorkloadQuery) -> tuple:
        out = self._preview_cache.get(wq.qid)
        if out is None:
            out = self._seed_answer(wq.query, seed=wq.saved_stats, key=wq.key)
            self._preview_cache[wq.qid] = out
        return out

    def _rollup_answer(self, wq: WorkloadQuery) -> Optional[tuple]:
        """Tier-1 answer preview from the query's promoted rollup cell,
        ``(m, estimate, lo, hi, err, having_decision)``, or None when no
        cell serves the pattern.  Cached per intake pass."""
        if self.rollup is None or wq.key is None:
            return None
        cell = self.rollup.get(wq.key)
        if cell is None or int(cell.m.sum()) == 0:
            return None
        out = self._rollup_cache.get(wq.qid)
        if out is None:
            m, est_v, lo, hi, err = self._seed_answer(
                wq.query, seed=cell.seed_dict())
            q = wq.query
            decision = -1
            if q.having is not None and m > 0:
                decision = int(est.having_decision(lo, hi, q.having.op,
                                                   q.having.threshold))
            out = (m, est_v, lo, hi, err, decision)
            self._rollup_cache[wq.qid] = out
        return out

    def _try_tier1(self, wq: WorkloadQuery) -> bool:
        """Answer ``wq`` from the rollup cache iff the cached answer meets
        its accuracy ask (the slot-effective ε, or a decided HAVING): no
        slot, no scan round."""
        if wq.query.group_by is not None:
            # a cell holds base-predicate scalar statistics only: it cannot
            # give the per-group cells a grouped answer promises
            return False
        ans = self._rollup_answer(wq)
        if ans is None:
            return False
        m, est_v, lo, hi, err, decision = ans
        if m == 0:
            return False
        eps_eff = wq.query.epsilon
        if self.scheduler is not None:
            eps_eff = self.scheduler.effective_epsilon(wq.query, wq.slo,
                                                       est_v)
        if err > eps_eff and decision == -1:
            return False
        now = self.t_model
        self.rollup.get(wq.key).touch(now)
        self.rollup.tier1_hits += 1
        self.rollup.observe(wq.query, wq.key, now)  # hits keep patterns hot
        latency = now - wq.arrival_t
        slo_met = None
        if wq.slo is not None:
            slo_met = wq.slo.met(latency, (hi - lo) / 2.0)
        if wq.explain is not None:
            wq.explain.tier = "tier1"
            wq.explain.tier_reason = (
                "promoted rollup cell decided the HAVING verdict"
                if err > eps_eff else
                f"promoted rollup cell meets target (err {err:.3g} <= "
                f"eps {eps_eff:.3g}); no slot, no scan rounds")
        self._finish(wq, WorkloadResult(
            qid=wq.qid, name=wq.query.name, estimate=est_v, lo=lo, hi=hi,
            err=err, decision=decision, plan="rollup",
            t_submit=wq.arrival_t, t_admit=now, t_done=now,
            seeded_tuples=m, tuples_seen=m, rounds_resident=0,
            sched_outcome="tier1", queue_wait=latency, slo_met=slo_met,
            priority=(wq.slo or NO_SLO).priority,
            degraded=self._quarantine_count > 0,
            chunks_quarantined=self._quarantine_count))
        return True

    def _rollup_on_retire(self, wq: WorkloadQuery, s: Optional[int],
                          valid: bool) -> None:
        """Completion hook of the rollup miner: log the pattern (promoting
        it once hot) and, when the query retired from a slot with real
        statistics, fold that row into its cell.  A newly promoted cell is
        birth-seeded from the synopsis, so the next repeat starts warm."""
        if self.rollup is None or wq.key is None:
            return
        promoted = self.rollup.observe(wq.query, wq.key, self.t_model)
        if promoted is not None and self.synopsis is not None:
            seed = self._mask_quarantined_seed(
                self.synopsis.seed_slot(wq.query))
            if seed is not None:
                promoted.fold(seed)
        if s is not None and valid:
            self.rollup.fold(wq.key, slot_stats_snapshot(self.state, s))

    def _observed_mean_service_s(self) -> Optional[float]:
        """Mean scan service over completed queries; None before the first
        retirement."""
        st = self._service_times
        return (sum(st) / len(st)) if st else None

    def _service_prior_s(self) -> float:
        """Cold-start per-job service for wait pricing: the observed mean
        service, else one full pass at the scan rate (never the
        candidate's own seed-discounted prediction: the queue is other
        queries' work)."""
        mean = self._observed_mean_service_s()
        if mean is not None:
            return mean
        return float(self._eff_tuples) / max(self._scan_rate, 1e-12)

    def _wait_components(self, ahead: list) -> tuple:
        """``(slot_drain_s, queue_ahead_service_s)``: the least remaining
        service over the resident slots (their class quantile minus their
        residence so far), and each queued job ahead at its own class's
        quantile."""
        model = self.scheduler.service_model
        prior = self._service_prior_s()
        now = self.t_model
        drains = []
        for s in range(self.max_slots):
            w = self.slot_wq[s]
            if w is None:
                continue
            pred = model.predict((w.slo or NO_SLO).priority, prior)
            drains.append(max(pred - max(now - self.slot_admit_t[s], 0.0),
                              0.0))
        drain = min(drains) if drains else None
        ahead_s = sum(model.predict((w.slo or NO_SLO).priority, prior)
                      for w in ahead)
        return drain, float(ahead_s)

    def _decide_admission(self, wq: WorkloadQuery, n_free: int, ahead: list):
        slo = wq.slo or NO_SLO
        grouped = wq.query.group_by is not None
        seed_m, seed_err, seed_est = 0, float("inf"), None
        rollup_err = float("inf")
        rollup = self._rollup_answer(wq)
        if rollup is not None:
            r_m, r_est, _, _, r_err, r_dec = rollup
            # a decided HAVING is as good as err 0; the cell also seeds the
            # feasibility price (the scan left to run)
            rollup_err = 0.0 if r_dec != -1 else r_err
            seed_m, seed_est, seed_err = r_m, r_est, r_err
        if self._wants_preview(wq):
            m, e, _, _, err = self._cached_preview(wq)
            if m > seed_m:
                seed_m, seed_est, seed_err = m, e, err
        if grouped:
            # a scalar answer can neither serve nor seed the group cells:
            # never Tier-1, and a full-pass price (seed_est stays the ε
            # translation's magnitude anchor)
            rollup_err = float("inf")
            seed_m, seed_err = 0, float("inf")
        drain, ahead_s = self._wait_components(ahead)
        load = ServerLoad(
            now=self.t_model, free_slots=n_free, queue_ahead=len(ahead),
            scan_rate=self._scan_rate,
            total_tuples=int(self._eff_tuples),
            mean_service_s=self._observed_mean_service_s(),
            slot_drain_s=drain, queue_ahead_service_s=ahead_s)
        # judge feasibility at the ε the slot will run at
        eps_eff = self.scheduler.effective_epsilon(wq.query, wq.slo, seed_est)
        return self.scheduler.admission.decide(
            arrival_t=wq.arrival_t, slo=slo, epsilon=eps_eff,
            load=load, seed_m=seed_m, seed_err=seed_err,
            rollup_err=rollup_err,
            group_count=(wq.query.group_by.effective_top_k if grouped else 0))

    def _best_seed(self, query: Query, key: Optional[tuple]) -> Optional[dict]:
        """The synopsis row for ``query``, or the promoted rollup cell of
        ``key`` when it out-samples the synopsis (a cell that missed the
        target alone still spares the slot its part of the scan)."""
        seed = self.synopsis.seed_slot(query) if self.synopsis else None
        cell = self.rollup.get(key) if self.rollup is not None else None
        if cell is not None and (seed is None or int(cell.m.sum())
                                 > int(np.asarray(seed["m"]).sum())):
            seed = cell.seed_dict()
        return seed

    def _seed_answer(self, query: Query, seed: Optional[dict] = None,
                     key: Optional[tuple] = None) -> tuple:
        """Best scan-free answer available now, ``(m, estimate, lo, hi,
        err)``; ``(0, nan, nan, nan, inf)`` when nothing can serve the
        query.  ``seed`` overrides the lookups (a preempted query's
        snapshot); otherwise the synopsis row and, when ``key`` names a
        promoted cell, the cell compete by sample size (the caller has
        refreshed the synopsis).  The seed is masked to the surviving
        chunks and priced over the surviving population.

        Computed on the host in float32, like the numpy policy that reads
        it: admission decisions do not depend on the device."""
        if seed is None:
            seed = self._best_seed(query, key)
        seed = self._mask_quarantined_seed(seed)
        if seed is None or int(np.asarray(seed["m"]).sum()) == 0:
            return 0, float("nan"), float("nan"), float("nan"), float("inf")

        def row(k):
            return torch.as_tensor(np.asarray(seed[k], np.float32))[None]

        stats_row = BiLevelStats(
            M=self._sizes_host,
            m=torch.as_tensor(np.asarray(seed["m"], np.int32)),
            ysum=row("ysum"), ysq=row("ysq"), psum=row("psum"),
            n_total=self._eff_chunks, m_total=self._eff_tuples)
        est_v, lo, hi, err = _answer_from_stats([query], stats_row)
        return (int(np.asarray(seed["m"]).sum()), float(est_v[0]),
                float(lo[0]), float(hi[0]), float(err[0]))

    def _shed(self, wq: WorkloadQuery) -> None:
        """Answer a shed query at once from the synopsis, flagged
        best-effort, or flag it unserved when no seed exists.  A shed query
        never holds a slot and costs no scan round."""
        now = self.t_model
        q = wq.query
        m_seen, estimate, lo, hi, err = self._cached_preview(wq)
        decision = -1
        if m_seen == 0:
            unserved, from_syn = True, False
        else:
            if q.having is not None:
                decision = int(est.having_decision(lo, hi, q.having.op,
                                                   q.having.threshold))
            unserved, from_syn = False, True
        latency = now - wq.arrival_t
        slo_met = None
        if wq.slo is not None:
            # a shed answer arrives at once, so the deadline alone would
            # always hit: it must also meet the accuracy ask (ε or a
            # decided HAVING)
            accurate = (not unserved) and (err <= q.epsilon or decision != -1)
            slo_met = accurate and wq.slo.met(latency, (hi - lo) / 2.0)
        if wq.explain is not None and not wq.explain.tier_reason:
            wq.explain.tier_reason = (
                "shed: no seed available, answer unserved" if unserved
                else "shed: best-effort synopsis answer, no scan rounds")
        self._finish(wq, WorkloadResult(
            qid=wq.qid, name=q.name, estimate=estimate, lo=lo, hi=hi,
            err=err, decision=decision, plan="shed",
            t_submit=wq.arrival_t, t_admit=now, t_done=now,
            seeded_tuples=m_seen, tuples_seen=m_seen, rounds_resident=0,
            from_synopsis=from_syn, unserved=unserved, sched_outcome="shed",
            queue_wait=latency, slo_met=slo_met,
            priority=(wq.slo or NO_SLO).priority,
            degraded=self._quarantine_count > 0,
            chunks_quarantined=self._quarantine_count))
        self.shed_count += 1
        # a shed still shows demand for the pattern: mine it (no fold, the
        # query never held a slot)
        self._rollup_on_retire(wq, None, False)

    def _admit(self, s: int, wq: WorkloadQuery) -> None:
        df = self._decoded_fraction()
        plan = wq.plan or select_plan(self.store, self.config, wq.query,
                                      rates=self.rates, decoded_fraction=df)
        row = wq.row or encode_slot(wq.query, self.store.codec.num_cols,
                                    max_groups=self.max_groups)
        row["plan"] = np.int32(PLAN_CODES[plan])
        self._refresh_synopsis()
        # a preempted query returning is seeded from its eviction snapshot
        # (every tuple it already counted)
        seed = self._mask_quarantined_seed(
            wq.saved_stats if wq.saved_stats is not None
            else self._best_seed(wq.query, wq.key))
        if (self.scheduler is not None and wq.slo is not None
                and np.isfinite(wq.slo.target_halfwidth)):
            # absolute CI half-width target -> the slot's relative ε,
            # anchored on the pass's cached preview
            _, seed_est, *_ = self._cached_preview(wq)
            row["eps"] = np.float32(self.scheduler.effective_epsilon(
                wq.query, wq.slo, seed_est))
        stats, seeded = slot_stats_write(self.state.stats, s, seed,
                                         self.store.num_chunks)
        stopped = self.state.stopped.clone()
        stopped[s] = False
        self.state = self.state._replace(stats=stats, stopped=stopped)
        if self._last_err is not None:
            # the previous occupant's error is stale for the new one: the
            # claim key reads it as "no estimate yet"
            self._last_err[s] = np.inf
        self.table = slot_table_set(self.table, s, row)
        # slot_table_set reset the row's weight: keep the mirror in step, or
        # _apply_scheduling could skip the next write and leave the new
        # occupant at full budget instead of its max-min share
        self._weights[s] = np.float32(row.get("weight", 1.0))
        self._slot_eps[s] = np.float32(row["eps"])
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
        self._rollup_on_retire(wq, s, True)
        slo_met = None
        if wq.slo is not None:
            slo_met = wq.slo.met(self.t_model - wq.arrival_t,
                                 (float(hi[0]) - float(lo[0])) / 2.0)
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
            sched_outcome=self._outcome(wq),
            queue_wait=self.slot_admit_t[s] - wq.arrival_t, slo_met=slo_met,
            priority=(wq.slo or NO_SLO).priority,
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

    def _rollup_group_cells(self, wq: WorkloadQuery, s: int) -> None:
        """Per-group rollup mining at retirement: each tracked cell is the
        completed run of its :func:`group_fanout` scalar pattern, so it
        feeds the miner under that pattern's key and, once promoted, folds
        the cell's per-chunk row into it."""
        gb = wq.query.group_by
        if self.rollup is None or gb is None:
            return
        tracked = self._slot_groups[s] or []
        if not tracked:
            return
        rows = slot_group_rows(self.state, s)
        base = dataclasses.replace(wq.query, group_by=None)
        for i, v in enumerate(tracked):
            fq = group_fanout(base, gb.col, [v])[0]
            key = pattern_key(fq, self.store.codec.num_cols)
            if key is None:
                continue
            self.rollup.observe(fq, key, self.t_model)
            self.rollup.fold(key, dict(
                m=rows["gm"][i], ysum=rows["gys"][i],
                ysq=rows["gyq"][i], psum=rows["gps"][i]))

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
            lo_f, hi_f = float(lo_a[s]), float(hi_a[s])
            slo_met = None
            if wq.slo is not None:
                slo_met = wq.slo.met(self.t_model - wq.arrival_t,
                                     float("nan") if bad
                                     else (hi_f - lo_f) / 2.0)
            if wq.explain is not None and not wq.explain.tier_reason:
                wq.explain.tier_reason = (
                    "scan exhausted before the slot saw any tuple" if bad
                    else "scan-served: retired at its stop condition")
            self._finish(wq, WorkloadResult(
                qid=wq.qid, name=wq.query.name,
                estimate=float("nan") if bad else float(est_a[s]),
                lo=lo_f, hi=hi_f, err=float(err_a[s]),
                decision=int(dec_a[s]), plan=self.slot_plan[s],
                t_submit=wq.arrival_t, t_admit=self.slot_admit_t[s],
                t_done=self.t_model, seeded_tuples=int(self.slot_seeded[s]),
                tuples_seen=int(m_rows[s].sum()),
                rounds_resident=int(self.rounds - self.slot_admit_round[s]),
                unserved=bad,
                sched_outcome=self._outcome(wq),
                queue_wait=float(self.slot_admit_t[s] - wq.arrival_t),
                slo_met=slo_met, priority=(wq.slo or NO_SLO).priority,
                groups=None if bad else self._group_results(rep, s, wq),
                **self._fault_fields(s)))
            service = self.t_model - self.slot_admit_t[s]
            self._service_times.append(service)
            if self.scheduler is not None:
                # the per-class service-time sketch (quantile admission)
                self.scheduler.observe_service(wq.slo, service)
            self._rollup_on_retire(wq, s, not bad)
            if not bad:
                self._rollup_group_cells(wq, s)
            self._release(s)

    def _any_active(self) -> bool:
        return any(wq is not None for wq in self.slot_wq)

    def _apply_scheduling(self) -> None:
        """Pre-round scheduler hooks: this round's fairness weights into
        the slot table and, under ``claim_policy="variance"``, the
        schedule's unclaimed tail reordered.  Both run before
        ``round_data``, so the streaming claim prediction and read-ahead
        follow the new order (the prefetcher keys its slabs by chunk id,
        so a slab read ahead under the old order still feeds its own
        chunk)."""
        sched = self.scheduler
        active = np.asarray([wq is not None for wq in self.slot_wq])
        w = sched.round_weights(
            [wq.slo if wq is not None else None for wq in self.slot_wq],
            active)
        if not np.array_equal(w, self._weights):
            self.table = self.table._replace(
                weight=torch.as_tensor(w, device=self.device))
            self._weights = w
        order = sched.claim_order(self.state, self.store.chunk_sizes,
                                  active=active, slot_need=self._slot_need())
        if order is not None:
            self.state = self.state._replace(
                schedule=torch.as_tensor(order, device=self.device))

    def _slot_need(self) -> Optional[np.ndarray]:
        """Per-slot ε-distance weights of the claim key, ``max(err/ε − 1,
        0)`` from the last round's report (1.0 for a slot with no estimate
        yet); ``None`` before the first round."""
        if self._last_err is None:
            return None
        eps = self._slot_eps.astype(np.float64)
        err = self._last_err
        return np.where(np.isfinite(err),
                        np.maximum(err / np.maximum(eps, 1e-12) - 1.0, 0.0),
                        1.0)

    def _enforce_deadlines(self) -> None:
        """Stop the slots whose SLO deadline has passed: the query retires
        this round with the best estimate available (time bounds trade
        against accuracy, not against an answer)."""
        now = self.t_model
        due = [s for s in range(self.max_slots)
               if self.slot_wq[s] is not None
               and self.slot_wq[s].slo is not None
               and self.slot_wq[s].slo.has_deadline
               and now >= self.slot_wq[s].arrival_t
               + self.slot_wq[s].slo.deadline_s]
        if not due:
            return
        stopped_now = self.state.stopped.cpu().numpy()
        late = [s for s in due if not stopped_now[s]]
        if late:
            stopped = self.state.stopped.clone()
            stopped[torch.as_tensor(late, device=stopped.device)] = True
            self.state = self.state._replace(stopped=stopped)

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
            if self.scheduler is not None:
                self._apply_scheduling()
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
            with tr.span("merge"):
                if self.rollup is not None and self.rollup.cells:
                    # resident slots running a promoted pattern fold their
                    # statistics into the cell: one batched copy, none when
                    # no such slot is resident
                    ids = [s for s in range(self.max_slots)
                           if self.slot_wq[s] is not None
                           and self.rollup.get(self.slot_wq[s].key)
                           is not None]
                    for s, row in slot_stats_fold(self.state, ids).items():
                        self.rollup.fold(self.slot_wq[s].key, row)
            with tr.span("estimate"):
                self._record_trajectory(rep, b)
                if self.scheduler is not None:
                    # next round's claim key reads this report
                    self._last_err = rep.err.cpu().numpy().astype(float)
                    if self.scheduler.config.deadline_enforcement:
                        self._enforce_deadlines()
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
        engine round.  Under a mesh the wall-clock cut is agreed across the
        ranks, so every rank stops after the same round."""
        self.truncated = False
        t0 = time.perf_counter()
        while self.queue or self._any_active():
            if self.rounds >= max_rounds:
                self.truncated = True
                break
            if self.engine.agree(time.perf_counter() - t0 > wall_timeout_s):
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
