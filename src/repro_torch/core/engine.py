"""The OLA-RAW engine: parallel bi-level sampling over raw chunks
(counterpart of ``repro.core.engine``).

One round of the lockstep state machine:

  1. CLAIM    — idle workers take the next positions of the committed random
                chunk schedule; the queue head advances by an exclusive
                prefix sum over the idle flags, so the started set is always
                a prefix of the schedule (the inspection-paradox guarantee).
  2. EXTRACT  — each active worker extracts the next ``b`` tuples of its chunk
                in the chunk's keyed Feistel order, decodes them from raw
                bytes and evaluates every query.  With
                ``extract_backend="cuda"`` gather, parse, evaluation and the
                per-(worker, query) sums are one fused kernel
                (``kernels/ops.slot_extract``: the CUDA kernel for a CUDA
                tensor, its plain version for a CPU one); ``"ref"`` keeps the
                decode + evaluator composition.
  3. MERGE    — per-chunk sufficient statistics are scatter-added.
  4. DECIDE   — per-chunk local accuracy closes chunks; the modeled resource
                monitor (Eq. 4's two cost terms) switches the resource-aware
                policy and drives the §5.4 budget rule.
  5. ESTIMATE — Eq. (1)/(3) over the started chunks; HAVING early-out.

Two query planes share the round: the frozen plane (a query list compiled
into the program; ``stats.m`` is ``(N,)``) and the slot table (a dynamic
:class:`~repro_torch.core.queries.SlotTable` round argument; ``stats.m`` is
per-slot ``(S, N)``, the scan-level count lives in ``state.scan_m``).

Raw data reaches the round in one of two residencies, on one device:
``"packed"`` holds the whole store on the device as one ``(N, M_max, rec)``
tensor; ``"stream"`` feeds each round a bounded ``(W, rows_max, rec)`` slab
of the chunks its workers claim, through
:class:`~repro_torch.data.pipeline.SlabPrefetcher`, optionally with the
parse-once decoded-chunk cache (``decoded_cache_bytes``).  Both give the
same statistics.  A read that exhausts its retries quarantines the chunk
(:func:`quarantine_chunks`) and the round re-plans over the survivors.

With ``EngineConfig.max_groups > 0`` the slot plane answers GROUP BY: every
slot owns G = max_groups + 1 group cells (the last the ``__other__`` spill)
with their own ``(S, G, N)`` statistics, and each round reports salted
group-value tallies the server folds into its discovery sketches.  The fused
grouped kernel runs under packed residency only; the ``"ref"`` composition
runs grouped rounds under both residencies.  PyTorch runs eagerly, so the
reference's jitted round per ``(b_static, decoded_mode)`` is a plain method
call here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import estimators as est
from repro_torch.core.estimators import BiLevelStats
from repro_torch.core.queries import (
    AGG_COUNT,
    AGG_SUM,
    HAVING_NONE,
    PLAN_CHUNK_LEVEL,
    PLAN_RESOURCE_AWARE,
    PLAN_SINGLE_PASS,
    Query,
    SlotTable,
    compile_queries,
    linear_plan,
    slot_evaluate,
)
from repro_torch.data.faults import FaultError
from repro_torch.data.pipeline import SlabPrefetcher
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import TALLY_BUCKETS, sum_last, tally_hash
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sampling.permutation import (
    chunk_seed,
    permutation_window_dyn,
    random_chunk_order,
)

# Chunk-claim sentinels for the per-worker `cur` slot (schedule positions).
IDLE = -1       # worker finished its chunk; will claim at next round start
EXHAUSTED = -2  # schedule empty; worker permanently idle

STRATEGIES = ("chunk_level", "holistic", "single_pass", "resource_aware",
              "chunk_level_unordered")

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_workers: int = 4
    strategy: str = "resource_aware"
    budget_init: int = 64        # t_eval analog: tuples per worker per round
    budget_min: int = 8          # paper's t_eval lower bound
    budget_max: int = 4096       # upper bound (also capped by chunk size)
    seed: int = 0
    # resource model: chunk fetch vs extract cost (the paper's testbed ratio)
    io_bytes_per_sec: float = 565e6
    cpu_tuple_ops_per_sec: float = 2.0e9
    # worker speed factors for straggler simulation (len == num_workers)
    worker_speed: Optional[tuple] = None
    stats_dtype: str = "float32"
    cache_cap: int = 0           # per-chunk extracted-tuple cache rows (synopsis)
    # round EXTRACT: "cuda" routes gather+parse+eval+reduce through the fused
    # kernel (kernels/ops.slot_extract — the CUDA kernel on the card, its
    # plain version for CPU tensors; linear+range plans, fixed-width ASCII,
    # f32 sums); "ref" keeps the decode_ref + evaluator composition; "auto"
    # picks "cuda" on a CUDA device where the kernel applies, else "ref"
    extract_backend: str = "cuda"
    # raw-data residency: "packed" keeps the whole store on the device as
    # one (N, M_max, rec) tensor; "stream" feeds each round a bounded
    # (W, rows_max, rec) slab through data/pipeline.SlabPrefetcher — device
    # residency O(slab), READ overlapped with compute.  Same statistics.
    residency: str = "packed"
    slab_row_tile: int = 256     # slab rows padded to a multiple of this
    prefetch_lookahead: int = 8  # schedule chunks the reader thread runs ahead
    # adapt the lookahead from the measured READ/round time ratio (a perf
    # knob only; estimates are unaffected)
    prefetch_adaptive: bool = False
    # parse-once decoded-chunk cache byte budget (streaming residency only):
    # each chunk's decoded (rows, C) f32 block is kept after its first
    # extraction and later rounds feed the decoded-input kernel, skipping
    # the parse.  Statistics and the modeled clock are the same on or off.
    decoded_cache_bytes: int = 0
    # grouped query plane (slot-table mode only): each slot owns max_groups
    # tracked group cells plus one __other__ spill cell, each with its own
    # (S, G, N) statistics; 0 keeps the group arrays zero-width and every
    # round ungrouped
    max_groups: int = 0

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.extract_backend not in ("ref", "cuda", "auto"):
            raise NotImplementedError(
                f"extract_backend={self.extract_backend!r}: this package has "
                "the 'cuda' fused kernel, the 'ref' composition and 'auto'")
        if self.residency not in ("packed", "stream"):
            raise ValueError(f"unknown residency {self.residency!r}")
        if self.decoded_cache_bytes < 0:
            raise ValueError("decoded_cache_bytes must be >= 0")
        if self.decoded_cache_bytes != 0 and self.residency != "stream":
            raise ValueError(
                "decoded_cache_bytes requires residency='stream' (the cache "
                "lives in the slab prefetcher)")
        if self.max_groups < 0:
            raise ValueError("max_groups must be >= 0")
        if self.stats_dtype not in ("float32", "float64"):
            raise ValueError("stats_dtype must be float32 or float64")


class EngineState(NamedTuple):
    stats: BiLevelStats      # ysum/ysq/psum (Q, N); m (N,) frozen, (S, N) slots
    scan_m: torch.Tensor     # (N,) int32 tuples the scan extracted per chunk
    offset: torch.Tensor     # (N,) int32 permutation cursor per chunk
    closed: torch.Tensor     # (N,) bool chunk closed for sampling
    acc_met: torch.Tensor    # (N,) bool local accuracy ε_j reached
    head: torch.Tensor       # () int32 queue head over the schedule
    cur: torch.Tensor        # (P,) int32 schedule position per worker
    budget: torch.Tensor     # () f32 current t_eval-analog budget
    decay: torch.Tensor      # () f32 §5.4 exponential-decay factor
    calib_sum: torch.Tensor  # () f32 Σ tuples-at-accuracy (calibration)
    calib_cnt: torch.Tensor  # () f32
    first_est: torch.Tensor  # () bool first chunk estimate produced
    stopped: torch.Tensor    # (Q,) bool per-query global stop
    round: torch.Tensor      # () int32
    t_io: torch.Tensor       # () f32 cumulative modeled read seconds
    t_cpu: torch.Tensor      # () f32 cumulative modeled extract seconds
    cpu_bound: torch.Tensor  # () bool monitor verdict from last round
    cached_m: torch.Tensor   # (N,) int32 tuples supplied by the synopsis
    raw_touched: torch.Tensor  # (N,) bool chunk has caused a raw READ
    cache: torch.Tensor      # (N, cap, C) f32 extracted-tuple cache
    schedule: torch.Tensor   # (N,) int32 claim order over chunk ids
    quarantined: torch.Tensor  # (N,) bool chunk dropped from the population
    # grouped plane, G = max_groups + 1 cells (the last __other__), all four
    # (S, 0, N) when the engine has max_groups == 0.  A cell's gm counts every
    # tuple its slot sampled while the cell was live (not group-filtered):
    # the per-chunk sample size a dedicated fan-out slot would carry.
    gm: torch.Tensor         # (S, G, N) int32 per-cell sample sizes
    gys: torch.Tensor        # (S, G, N) per-cell Σ x (group-masked)
    gyq: torch.Tensor        # (S, G, N) per-cell Σ x²
    gps: torch.Tensor        # (S, G, N) per-cell Σ p (base predicate ∧ group)


class RoundReport(NamedTuple):
    estimate: torch.Tensor     # (Q,)
    lo: torch.Tensor           # (Q,)
    hi: torch.Tensor           # (Q,)
    err: torch.Tensor          # (Q,) error ratio (paper's metric)
    decided: torch.Tensor      # (Q,) int8 HAVING verdict (-1/0/1)
    n_chunks: torch.Tensor     # () chunks in sample
    m_tuples: torch.Tensor     # () tuples in sample
    round_io_s: torch.Tensor   # () modeled read seconds this round
    round_cpu_s: torch.Tensor  # () modeled extract seconds this round
    tuples_round: torch.Tensor  # ()
    bytes_round: torch.Tensor  # ()
    all_stopped: torch.Tensor  # () bool
    exhausted: torch.Tensor    # () bool — every chunk closed
    # grouped plane, (S, G) per-cell answers ((Q, 0) when ungrouped)
    g_est: torch.Tensor        # (S, G) per-cell estimates
    g_lo: torch.Tensor         # (S, G)
    g_hi: torch.Tensor         # (S, G)
    g_err: torch.Tensor        # (S, G) per-cell error ratio
    g_n: torch.Tensor          # (S, G) int32 tuples in each cell's sample
    g_tal: torch.Tensor        # (S, 3, H) this round's [count, Σv, Σv²] per
                               # salted-hash bucket of the slot's group value
                               # (counted base-predicate rows only), which the
                               # server folds into its discovery sketches


class _Collectives:
    """Seam between single-device and multi-rank rounds.

    ``gather_workers`` exposes every worker's flag in global worker order;
    ``merge(sums, workers)`` returns one dict holding ``sums`` summed over
    the ranks and ``workers`` (per-worker tensors, worker axis first)
    gathered over every worker in global worker order, bit for bit;
    ``my_base`` is this rank's first global worker id.  ``any`` and
    ``maximum`` agree a host decision or a tensor across the ranks.  On one
    device every operation is the identity, so both modes run the same
    round body; :class:`GroupCollectives` is the multi-rank instance."""

    ranks = 1

    def gather_workers(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def merge(self, sums: dict, workers: Optional[dict] = None) -> dict:
        return {**sums, **(workers or {})}

    def my_base(self) -> int:
        return 0

    def any(self, flag: bool) -> bool:
        return bool(flag)

    def maximum(self, x: torch.Tensor) -> torch.Tensor:
        return x


class GroupCollectives(_Collectives):
    """:class:`_Collectives` over a ``torch.distributed`` process group: one
    program per rank, the rank's ``workers_per_rank`` workers are its shard
    of the worker axis, and ``device`` is where the rank's tensors live.

    A merge packs its tensors into one flat buffer per wire dtype and runs
    one ``all_reduce(SUM)`` each (typically an int32 and a float one).
    Summed entries travel as themselves (bools as int32).  A gathered
    entry travels as the 32-bit words of its values (a float32 or int32 as
    one word, a float64 or int64 as two, a bool or byte widened to one) in
    a zero-filled ``(W, words)`` int32 buffer that holds this rank's
    workers at its own rows, so the gathers of a merge share its int32
    reduction with the integer sums: every element has one
    contributor, and an integer sum of one value and zeros is that value,
    so the gather is exact for any value, -0.0 and NaN included.  Gathers
    ride the same reduction as sums, so no backend needs ``all_gather``
    (gloo has none for CUDA tensors) and the engine never branches on the
    backend."""

    def __init__(self, group, rank: int, ranks: int, workers_per_rank: int,
                 device):
        self.group = group
        self.rank = int(rank)
        self.ranks = int(ranks)
        self.wpd = int(workers_per_rank)
        self.device = torch.device(device)

    def my_base(self) -> int:
        return self.rank * self.wpd

    def _all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op,
                        group=self.group)
        return t

    def gather_workers(self, x: torch.Tensor) -> torch.Tensor:
        return self.merge({}, {"x": x})["x"]

    def merge(self, sums: dict, workers: Optional[dict] = None) -> dict:
        workers = workers or {}
        wire: dict[torch.dtype, list] = {}
        for key, t in sums.items():
            carrier = torch.int32 if t.dtype == torch.bool else t.dtype
            wire.setdefault(carrier, []).append(
                (key, t, False, t.to(carrier).reshape(-1)))
        base, wpd = self.my_base(), self.wpd
        for key, t in workers.items():
            if t.shape[0] != wpd:
                raise ValueError(f"merge: {key!r} has {t.shape[0]} workers, "
                                 f"this rank holds {wpd}")
            rows = t.reshape(wpd, t.numel() // wpd)
            words = (rows.to(torch.int32) if t.element_size() == 1
                     else rows.contiguous().view(torch.int32))
            full = torch.zeros((self.ranks * wpd, words.shape[1]),
                               dtype=torch.int32, device=t.device)
            full[base:base + wpd] = words
            wire.setdefault(torch.int32, []).append(
                (key, t, True, full.reshape(-1)))
        out = {}
        # one reduction per wire dtype, in an order every rank agrees on
        for carrier in sorted(wire, key=str):
            parts = wire[carrier]
            flat = self._all_reduce(torch.cat([p[3] for p in parts]))
            at = 0
            for key, t, gathered, part in parts:
                seg = flat[at:at + part.numel()]
                at += part.numel()
                if not gathered:
                    out[key] = seg.reshape(t.shape).to(t.dtype)
                    continue
                seg = seg.reshape(self.ranks * wpd,
                                  part.numel() // (self.ranks * wpd))
                seg = (seg.to(t.dtype) if t.element_size() == 1
                       else seg.view(t.dtype))
                out[key] = seg.reshape((self.ranks * wpd,)
                                       + tuple(t.shape[1:]))
        return out

    def any(self, flag: bool) -> bool:
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        return bool(int(self._all_reduce(t).item()) > 0)

    def maximum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._all_reduce(x.clone(), dist.ReduceOp.MAX)


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


class EngineProgram:
    """The round program, independent of host-side orchestration: the
    static parts (schedule, seeds, query evaluator, cost model) live here,
    per-round state is the :class:`EngineState`."""

    def __init__(self, *, codec, queries: Sequence[Query] = (),
                 config: EngineConfig, n_chunks: int, m_max: int,
                 chunk_sizes: np.ndarray,
                 schedule: Optional[np.ndarray] = None,
                 max_slots: Optional[int] = None, confidence: float = 0.95,
                 device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.codec = codec
        self.queries = list(queries)
        self.config = config
        self.n_chunks = int(n_chunks)
        self.m_max = int(m_max)
        self.max_slots = None if max_slots is None else int(max_slots)
        if schedule is None:
            schedule = random_chunk_order(config.seed, self.n_chunks)
        self.schedule_np = np.asarray(schedule, np.int32)
        self.seeds = chunk_seed(config.seed,
                                torch.arange(self.n_chunks, device=dev))
        self.chunk_sizes_np = np.asarray(chunk_sizes, np.int32)
        self.chunk_bytes = torch.as_tensor(
            np.asarray(chunk_sizes, np.float32) * codec.record_bytes,
            device=dev)
        if self.max_slots is None:
            if not self.queries:
                raise ValueError("frozen mode needs a non-empty query list")
            self.evaluate = compile_queries(self.queries)
            self.eps = torch.tensor([q.epsilon for q in self.queries],
                                    dtype=torch.float32, device=dev)
            self.conf = float(self.queries[0].confidence)
        else:
            # slot-table mode: the query plane is a round argument and each
            # slot carries its own z; ``confidence`` is a reporting default
            if self.queries:
                raise ValueError("slot mode takes queries via the table")
            self.evaluate = None
            self.eps = torch.zeros((self.max_slots,), dtype=torch.float32,
                                   device=dev)
            self.conf = float(confidence)
        self.z = float(est.z_score(self.conf))
        self.cost_per_tuple = float(codec.extract_cost_per_tuple())
        self.total_tuples = int(np.sum(chunk_sizes))
        self.num_cols = int(codec.num_cols)
        self.dtype = getattr(torch, config.stats_dtype)
        # grouped-plane sizing: G cells per slot including __other__, H tally
        # buckets for the online discovery sketches
        self.group_cells = config.max_groups + 1 if config.max_groups else 0
        self.tally_buckets = TALLY_BUCKETS if self.group_cells else 0
        if self.group_cells and self.max_slots is None:
            raise ValueError(
                "max_groups > 0 requires slot-table mode (grouped queries "
                "run through the workload slot plane)")
        # the fused kernel parses fixed-width ASCII, needs linear+range
        # plans and sums in f32: outside that an explicit "cuda" raises
        # here, not mid-scan (use "ref" there), while "auto" resolves to
        # "cuda" only on a CUDA device where the kernel applies
        kernel_ok = (getattr(codec, "name", "") == "ascii"
                     and self.dtype == torch.float32)
        backend = config.extract_backend
        if backend == "auto":
            backend = "cuda" if dev.type == "cuda" and kernel_ok else "ref"
            if backend == "cuda" and self.max_slots is None:
                try:
                    linear_plan(self.queries, self.num_cols)
                except ValueError:
                    backend = "ref"
        self.extract_backend = backend
        self.fused = backend == "cuda"
        if self.fused:
            if not kernel_ok:
                raise ValueError(
                    "extract_backend='cuda' requires the fixed-width ASCII "
                    "codec and float32 stats (the fused kernel parses ASCII "
                    "records and accumulates its sums in f32)")
            if self.group_cells and config.residency == "stream":
                raise ValueError(
                    "grouped queries (max_groups > 0) support the fused "
                    "kernel only under residency='packed'; use "
                    "extract_backend='ref' for streaming rounds")
            if self.max_slots is None:
                lp = linear_plan(self.queries, self.num_cols)
                self._plan_coeffs = torch.as_tensor(lp.coeffs, device=dev)
                self._plan_lo = torch.as_tensor(lp.lo, device=dev)
                self._plan_hi = torch.as_tensor(lp.hi, device=dev)
                self._plan_is_count = torch.tensor(
                    [1.0 if q.agg == "count" else 0.0 for q in self.queries],
                    dtype=torch.float32, device=dev)

    @property
    def q_dim(self) -> int:
        """Leading stats dimension: query count or slot count."""
        return self.max_slots if self.max_slots is not None else len(self.queries)

    # ------------------------------------------------------------ state ----
    def init_state(self, synopsis_seed: Optional[dict] = None) -> EngineState:
        cfg = self.config
        dev = self.device
        q, n = self.q_dim, self.n_chunks
        dtype = self.dtype
        sizes = torch.as_tensor(self.chunk_sizes_np, device=dev)
        stats = est.init_stats(sizes, query_shape=(q,), dtype=dtype,
                               m_total=self.total_tuples)
        if self.max_slots is not None:
            # per-slot sample sizes: each slot joined the scan at its own time
            if synopsis_seed is not None:
                raise ValueError("slot mode seeds per-slot via the server")
            stats = stats._replace(m=torch.zeros((q, n), dtype=_I32,
                                                 device=dev))

        def scalar(v, dt):
            return torch.tensor(v, dtype=dt, device=dev)

        state = EngineState(
            stats=stats,
            scan_m=torch.zeros((n,), dtype=_I32, device=dev),
            offset=torch.zeros((n,), dtype=_I32, device=dev),
            closed=torch.zeros((n,), dtype=torch.bool, device=dev),
            acc_met=torch.zeros((n,), dtype=torch.bool, device=dev),
            head=scalar(0, _I32),
            cur=torch.full((cfg.num_workers,), IDLE, dtype=_I32, device=dev),
            budget=scalar(float(cfg.budget_init), torch.float32),
            decay=scalar(1.0, torch.float32),
            calib_sum=scalar(0.0, torch.float32),
            calib_cnt=scalar(0.0, torch.float32),
            first_est=scalar(False, torch.bool),
            stopped=torch.zeros((q,), dtype=torch.bool, device=dev),
            round=scalar(0, _I32),
            t_io=scalar(0.0, torch.float32),
            t_cpu=scalar(0.0, torch.float32),
            cpu_bound=scalar(False, torch.bool),
            cached_m=torch.zeros((n,), dtype=_I32, device=dev),
            raw_touched=torch.zeros((n,), dtype=torch.bool, device=dev),
            cache=torch.zeros((n, cfg.cache_cap, self.num_cols),
                              dtype=torch.float32, device=dev),
            schedule=torch.as_tensor(self.schedule_np, device=dev),
            quarantined=torch.zeros((n,), dtype=torch.bool, device=dev),
            gm=torch.zeros((q, self.group_cells, n), dtype=_I32, device=dev),
            gys=torch.zeros((q, self.group_cells, n), dtype=dtype, device=dev),
            gyq=torch.zeros((q, self.group_cells, n), dtype=dtype, device=dev),
            gps=torch.zeros((q, self.group_cells, n), dtype=dtype, device=dev),
        )
        if synopsis_seed is not None:
            def t(key, dt):
                return torch.as_tensor(np.asarray(synopsis_seed[key]),
                                       device=dev).to(dt)

            stats = state.stats._replace(
                m=t("m", _I32), ysum=t("ysum", dtype), ysq=t("ysq", dtype),
                psum=t("psum", dtype))
            closed = synopsis_seed.get("closed", np.zeros(n, bool))
            state = state._replace(
                stats=stats, scan_m=t("m", _I32), offset=t("offset", _I32),
                closed=torch.as_tensor(np.asarray(closed, bool), device=dev),
                cached_m=t("m", _I32))
            if "cache" in synopsis_seed and cfg.cache_cap > 0:
                pre = t("cache", torch.float32)
                cache = state.cache.clone()
                cache[:, : pre.shape[1]] = pre
                state = state._replace(cache=cache)
        return state

    def plan_claims(self, state: EngineState, cur: Optional[torch.Tensor]
                    = None) -> tuple[np.ndarray, np.ndarray, int]:
        """Host-side replica of the round's CLAIM step: which chunk each
        worker holds this round, which workers are active, and the new
        queue head — a pure function of ``(cur, head, schedule)``.  ``cur``
        is every worker's claim in global worker order (default
        ``state.cur``, which holds them all on one device)."""
        cur = (state.cur if cur is None else cur).cpu().numpy().astype(
            np.int64)
        head = int(state.head)
        n = self.n_chunks
        schedule = state.schedule.cpu().numpy()
        idle = cur == IDLE
        ranks = np.cumsum(idle) - idle
        want = head + ranks
        got = idle & (want < n)
        cur_next = np.where(got, want, np.where(idle, EXHAUSTED, cur))
        j = schedule[np.clip(cur_next, 0, n - 1)]
        active = cur_next >= 0
        new_head = head + int(np.sum(idle & (want < n)))
        return j, active, new_head

    def _closed_prefix_mask(self, closed: torch.Tensor,
                            schedule: torch.Tensor) -> torch.Tensor:
        """Reordering barrier (§3): chunk-level estimation may only use the
        closed prefix of the schedule.  Returns the (N,) chunk mask."""
        n = self.n_chunks
        done_sched = closed[schedule.long()]
        not_done = ~done_sched
        prefix_len = torch.where(
            torch.all(done_sched),
            torch.full((), n, dtype=torch.int64, device=closed.device),
            torch.argmax(not_done.to(_I32)))
        mask = torch.zeros((n,), dtype=torch.bool, device=closed.device)
        mask[schedule.long()] = torch.arange(n, device=closed.device) < prefix_len
        return mask

    def _round_tallies(self, colv: torch.Tensor, pr: torch.Tensor,
                       live: torch.Tensor, rnd: torch.Tensor,
                       dtype) -> torch.Tensor:
        """Per-slot ``(S, 3, H)`` group-value tallies ``[count, Σv, Σv²]``
        bucketed by the round-salted hash of the group value.  ``pr`` is the
        fully masked predicate indicator, so only counted base-predicate
        rows tally; ``live`` (S,) keeps them to slots still discovering
        groups (their ``__other__`` cell is live).  The adds land in the
        reference's scatter order (slot, worker, window position)."""
        s, w, b = colv.shape
        hbk = self.tally_buckets
        h = tally_hash(colv, rnd, hbk)                           # (S, W, B)
        flat = (torch.arange(s, device=colv.device)[:, None, None] * hbk
                + h).reshape(-1)
        prf = (pr * live[:, None, None].to(pr.dtype)).reshape(-1).to(dtype)
        cv = colv.reshape(-1).to(dtype)
        moments = torch.stack([prf, prf * cv, prf * cv * cv], -1)
        tal = torch.zeros((s * hbk, 3), dtype=dtype,
                          device=colv.device).index_add_(0, flat, moments)
        return tal.reshape(s, hbk, 3).permute(0, 2, 1).contiguous()

    # ------------------------------------------------------------ round ----
    def round_body(self, state: EngineState, data, speeds: torch.Tensor,
                   b_static: int, coll: Optional[_Collectives] = None,
                   slots: Optional[SlotTable] = None,
                   decoded_mode: str = "none",
                   ) -> tuple[EngineState, RoundReport]:
        """One engine round.  ``data`` is the raw byte source: the packed
        store ``(N, M_max, rec)`` under ``residency="packed"``, or this
        round's per-worker slab ``(W, rows_max, rec)`` under ``"stream"``
        (worker w's chunk rows at ``data[w]``, assembled from
        :meth:`plan_claims`, which the CLAIM below reproduces).

        ``decoded_mode`` (streaming with the decoded-chunk cache) picks the
        variant: ``"none"`` is the raw-slab round; otherwise ``data`` is the
        prefetcher's ``(raw_slab, decoded_slab, is_decoded)`` triple —
        ``"all"`` evaluates the decoded slab only, ``"mixed"`` splits the
        budget between the raw and decoded kernels by the mask.  Every
        variant gives the same statistics and modeled clock.

        With ``slots`` the query plane is the slot table: evaluation, ε
        targets, plan policies and HAVING verdicts come from its rows."""
        cfg = self.config
        streaming = cfg.residency == "stream"
        if decoded_mode not in ("none", "mixed", "all"):
            raise ValueError(f"unknown decoded_mode {decoded_mode!r}")
        if decoded_mode != "none":
            if not streaming:
                raise ValueError("decoded rounds exist only under streaming")
            data, dec, is_dec = data
        coll = coll or _Collectives()
        n = self.n_chunks
        slot_mode = slots is not None
        grouped = slot_mode and self.group_cells > 0
        if slot_mode and slots.group_cells != self.group_cells:
            raise ValueError("slot table group capacity != engine max_groups")
        q = self.q_dim
        dtype = state.stats.ysum.dtype
        sizes = state.stats.M
        dev = state.cur.device

        # ---- 1. CLAIM: prefix-sum queue-head allocation -------------------
        idle_local = state.cur == IDLE
        idle_all = coll.gather_workers(idle_local)
        idle_i = idle_all.to(_I32)
        ranks_all = torch.cumsum(idle_i, 0, dtype=_I32) - idle_i
        w_local = state.cur.shape[0]
        my_ids = coll.my_base() + torch.arange(w_local, device=dev)
        ranks = ranks_all[my_ids]
        want_pos = state.head + ranks
        got = idle_local & (want_pos < n)
        cur = torch.where(got, want_pos,
                          torch.where(idle_local,
                                      torch.full_like(state.cur, EXHAUSTED),
                                      state.cur)).to(_I32)
        head = (state.head + torch.sum(
            idle_all & (state.head + ranks_all < n))).to(_I32)

        active = cur >= 0
        j = state.schedule[torch.clamp(cur, 0, n - 1).long()].long()  # (W,)
        mj = sizes[j]
        off = state.offset[j]                                    # cursor
        m_before = state.scan_m[j]                               # scan so far

        # ---- 2. EXTRACT ----------------------------------------------------
        # remaining unsampled tuples bound the budget
        zero_i = torch.zeros_like(mj)
        b_eff = torch.minimum(
            torch.floor(b_static * speeds).to(_I32),
            torch.clamp(mj - m_before, min=0))
        b_eff = torch.where(active, b_eff, zero_i)
        # a quarantined chunk yields nothing; its worker releases it below
        b_eff = torch.where(state.quarantined[j], zero_i, b_eff)
        k = torch.arange(b_static, dtype=_I32, device=dev)
        valid = k[None, :] < b_eff[:, None]                      # (W, B)
        if slot_mode:
            # fairness weights: slot s counts only the first
            # ceil(weight_s · b_eff) tuples of each worker window this round
            b_slot = torch.minimum(
                torch.ceil(slots.weight[:, None]
                           * b_eff[None, :].to(torch.float32)).to(_I32),
                b_eff[None, :])                                  # (S, W)

        idx = permutation_window_dyn(self.seeds[j], off, b_static, mj,
                                     self.m_max)                 # (W, B)
        cap = cfg.cache_cap
        cols = None
        cache_rows = None
        if self.fused:
            # gather + parse + slot eval + per-(worker, slot) partial sums
            # in one kernel; the decoded window is emitted only when the
            # synopsis extraction cache needs it
            if slot_mode:
                coeffs, p_lo, p_hi = slots.coeffs, slots.lo, slots.hi
                isc = (slots.agg == AGG_COUNT).to(torch.float32)
                gate_v = slots.active.to(torch.float32)
                wts = slots.weight
            else:
                coeffs, p_lo, p_hi = (self._plan_coeffs, self._plan_lo,
                                      self._plan_hi)
                isc = self._plan_is_count
                gate_v = torch.ones((q,), dtype=torch.float32, device=dev)
                wts = torch.ones((q,), dtype=torch.float32, device=dev)
            if streaming:
                # the slab kernels emit the synopsis-cache delta rows
                # (W, cap, C) themselves when cap > 0
                def stream(kernel, src, budgets):
                    return kernel(src, idx, budgets, coeffs, p_lo, p_hi, isc,
                                  gate_v, weights=wts, cache_cap=cap,
                                  m_before=m_before)

                if decoded_mode == "all":
                    res = stream(kernel_ops.slot_eval_decoded, dec, b_eff)
                elif decoded_mode == "mixed":
                    # complementary budgets: a zero-budget worker adds exact
                    # float zeros, so the two outputs sum to the one-kernel
                    # result bit for bit
                    b_raw = torch.where(is_dec, zero_i, b_eff)
                    r_raw = stream(kernel_ops.slot_extract_stream, data, b_raw)
                    r_dec = stream(kernel_ops.slot_eval_decoded, dec,
                                   b_eff - b_raw)
                    res = ((r_raw[0] + r_dec[0], r_raw[1] + r_dec[1])
                           if cap > 0 else r_raw + r_dec)
                else:
                    res = stream(kernel_ops.slot_extract_stream, data, b_eff)
                stats4, cache_rows = res if cap > 0 else (res, None)
            elif grouped:
                stats4, cols, gstats4, tal_w = kernel_ops.slot_extract(
                    data, j, idx, b_eff, coeffs, p_lo, p_hi, isc, gate_v,
                    weights=wts, return_cols=cap > 0, gcol=slots.gcol,
                    gval=slots.gval, gact=slots.gact, salt=state.round,
                    tally_buckets=self.tally_buckets)
                # (W, S, G, 4) partials -> (S, G, W) sums; the workers'
                # (W, S, 3, H) tallies add up to the round's (S, 3, H)
                # after the merge
                g_sum_x = torch.movedim(gstats4[..., 1].to(dtype), 0, -1)
                g_sum_xx = torch.movedim(gstats4[..., 2].to(dtype), 0, -1)
                g_sum_p = torch.movedim(gstats4[..., 3].to(dtype), 0, -1)
                tally_in = dict(tal_w=tal_w.to(dtype))
            else:
                stats4, cols = kernel_ops.slot_extract(
                    data, j, idx, b_eff, coeffs, p_lo, p_hi, isc, gate_v,
                    weights=wts, return_cols=cap > 0)
            sum_x = stats4[..., 1].to(dtype).T                   # (Q|S, W)
            sum_xx = stats4[..., 2].to(dtype).T
            sum_p = stats4[..., 3].to(dtype).T
        else:
            w_ids = torch.arange(idx.shape[0], device=dev)[:, None]
            if decoded_mode == "all":
                cols = dec[w_ids, idx.long()]                    # (W, B, C)
            else:
                src = w_ids if streaming else j[:, None]
                raw = data[src, idx.long()]                      # (W, B, rec)
                cols = self.codec.decode_ref(raw)                # (W, B, C)
                if decoded_mode == "mixed":
                    # the decode is row-elementwise: decoded-slab gathers
                    # equal gather-then-decode bit for bit
                    cols = torch.where(is_dec[:, None, None],
                                       dec[w_ids, idx.long()], cols)
            if slot_mode:
                x, pr = slot_evaluate(slots, cols)               # (S, W, B)
                gate = slots.active.to(dtype)[:, None, None]
                # per-slot window prefix (fairness): k < b_slot[s, w]
                vf = (k[None, None, :] < b_slot[:, :, None]).to(dtype)
            else:
                x, pr = self.evaluate(cols)                      # (Q, W, B)
                gate = torch.ones((), dtype=dtype, device=dev)
                vf = valid.to(dtype)[None]
            x = x.to(dtype) * vf * gate
            pr = pr.to(dtype) * vf * gate
            sum_x = sum_last(x)                                  # (Q|S, W)
            sum_xx = sum_last(x * x)
            sum_p = sum_last(pr)
            if grouped:
                # per-cell sums from the decoded window.  Every mask factor
                # is an exact 0/1 float, so a tracked cell's products are
                # the group_fanout slot's bit for bit; a row matches at most
                # one tracked value, so __other__ is the complement
                gcol_c = torch.clamp(slots.gcol.long(), 0, self.num_cols - 1)
                colv = torch.movedim(cols, -1, 0)[gcol_c]        # (S, W, B)
                gvals = slots.gval.to(dtype)
                gactf = slots.gact.to(dtype)
                eq = (colv[:, None] == gvals[:, :, None, None]).to(dtype)
                trk = eq * gactf[:, :, None, None]               # (S, G, W, B)
                other = ((1.0 - torch.sum(trk[:, :-1], dim=1))
                         * gactf[:, -1][:, None, None])          # (S, W, B)
                ind = torch.cat([trk[:, :-1], other[:, None]], dim=1)
                gx = ind * x[:, None]                            # (S, G, W, B)
                gp = ind * pr[:, None]
                g_sum_x = sum_last(gx)                           # (S, G, W)
                g_sum_xx = sum_last(gx * gx)
                g_sum_p = sum_last(gp)
                # the tallies' inputs, worker axis first; the tallies are
                # folded after the merge
                tally_in = dict(colv=torch.movedim(colv, 1, 0),
                                pr=torch.movedim(pr, 1, 0))

        # ---- 3. MERGE -------------------------------------------------------
        # index_add_ replaces the reference's scatter-add.  Active workers
        # hold distinct chunks and inactive ones add exact zeros (x + 0 == x
        # in IEEE arithmetic), so each chunk receives at most one non-zero
        # contribution per round and the result does not depend on the
        # order in which the adds land: neither within a rank nor in the
        # sum of the ranks' partials, which is why a merged delta equals
        # the single-device index_add_ bit for bit.  Three quantities add
        # several non-zero terms into one number: the READ bytes (a float32
        # sum over the workers), the group tallies (many workers' rows into
        # one bucket) and the calibration sums below.  A float sum's bits
        # follow the order of its adds, so their per-worker terms are
        # gathered instead, bit for bit, and every rank folds them over all
        # workers in the single-device order.
        af = active.to(_I32)
        deltas = dict(
            dm=_zeros((n,), _I32, mj).index_add_(0, j, b_eff * af),
            dys=_zeros((q, n), dtype, mj).index_add_(1, j, sum_x * af),
            dyq=_zeros((q, n), dtype, mj).index_add_(1, j, sum_xx * af),
            dps=_zeros((q, n), dtype, mj).index_add_(1, j, sum_p * af),
        )
        if slot_mode:
            # per-slot sample-size deltas honor the fairness budgets
            deltas["dmq"] = _zeros((q, n), _I32, mj).index_add_(
                1, j, b_slot * af[None, :])
        if grouped:
            gshape = (q, self.group_cells, n)
            deltas["dgys"] = _zeros(gshape, dtype, mj).index_add_(
                2, j, g_sum_x * af)
            deltas["dgyq"] = _zeros(gshape, dtype, mj).index_add_(
                2, j, g_sum_xx * af)
            deltas["dgps"] = _zeros(gshape, dtype, mj).index_add_(
                2, j, g_sum_p * af)

        # READ accounting: a chunk costs its full raw bytes the first time it
        # is extracted beyond what the synopsis supplied (Section 6.3)
        needs_raw = active & (b_eff > 0) & (m_before >= state.cached_m[j])
        newly_raw = needs_raw & ~state.raw_touched[j]
        deltas["touched"] = _zeros((n,), _I32, mj).index_add_(
            0, j, newly_raw.to(_I32))
        workers = dict(bytes_w=torch.where(
            newly_raw, self.chunk_bytes[j],
            torch.zeros((), dtype=torch.float32, device=dev)))
        if grouped:
            workers.update(tally_in)
        # extracted-tuple cache for synopsis construction: row r of chunk j
        # holds the r-th tuple of its permutation window (append-only).  The
        # slab kernels emit a per-worker delta, (W, cap, C) rows zero off
        # the window; under several ranks the packed path scatters its
        # decoded window into one too.  Gathered with the workers' chunk
        # ids, the delta lands in the cache by one index_add_ over every
        # worker on every rank.
        def window():
            rows = m_before[:, None] + k[None, :]                # (W, B)
            writable = valid & active[:, None] & (rows < cap)
            wi, ki = torch.nonzero(writable, as_tuple=True)
            return wi, rows[wi, ki].long(), cols[wi, ki]

        if cap > 0 and cache_rows is None and coll.ranks > 1:
            wi, ri, vals = window()
            cache_rows = torch.zeros(
                (w_local, cap, self.num_cols), dtype=torch.float32,
                device=dev).index_put_((wi, ri), vals)
        if cache_rows is not None:
            workers.update(cache_rows=cache_rows, cache_j=j)
        deltas = coll.merge(deltas, workers)
        if slot_mode:
            # a slot only counts tuples extracted while it is active
            dm_q = slots.active.to(_I32)[:, None] * deltas["dmq"]
        else:
            dm_q = deltas["dm"]
        stats = state.stats._replace(
            m=state.stats.m + dm_q,
            ysum=state.stats.ysum + deltas["dys"],
            ysq=state.stats.ysq + deltas["dyq"],
            psum=state.stats.psum + deltas["dps"])
        if grouped:
            # a cell's m counts every tuple its slot sampled while the cell
            # was live; a cell activated mid-scan accumulates from then on
            # (a contiguous window of each chunk's permutation is still a
            # uniform without-replacement sample)
            gact_i = slots.gact.to(_I32)
            gm_new = state.gm + dm_q[:, None, :] * gact_i[:, :, None]
            gys_new = state.gys + deltas["dgys"]
            gyq_new = state.gyq + deltas["dgyq"]
            gps_new = state.gps + deltas["dgps"]
            if self.fused:
                g_tal = torch.sum(deltas["tal_w"], dim=0)
            else:
                g_tal = self._round_tallies(
                    torch.movedim(deltas["colv"], 0, 1),
                    torch.movedim(deltas["pr"], 0, 1), gactf[:, -1],
                    state.round, dtype)
        else:
            gm_new, gys_new = state.gm, state.gys
            gyq_new, gps_new = state.gyq, state.gps
            g_tal = torch.zeros((q, 3, self.tally_buckets), dtype=dtype,
                                device=dev)
        scan_m = state.scan_m + deltas["dm"]
        offset = state.offset + deltas["dm"]
        raw_touched = state.raw_touched | (deltas["touched"] > 0)
        bytes_round = torch.sum(deltas["bytes_w"])
        if cache_rows is not None:
            # rows off the window are zero, so inactive workers (and the
            # chunk ids they repeat) add nothing
            cache = state.cache + torch.zeros_like(state.cache).index_add_(
                0, deltas["cache_j"], deltas["cache_rows"])
        elif cap > 0:
            # one device, packed: the window's rows straight into a copy
            wi, ri, vals = window()
            cache = state.cache.clone()
            cache.index_put_((j[wi], ri), vals, accumulate=True)
        else:
            cache = state.cache

        # ---- 4. DECIDE -------------------------------------------------------
        # per-slot sample sizes: (W,) in frozen mode, (S, W) in slot mode
        mj_new = stats.m[..., j].to(dtype)
        scan_mj = scan_m[j].to(dtype)                            # (W,)
        big_m = sizes[j].to(dtype)
        scale = big_m / torch.clamp(mj_new, min=1.0)
        ys_j = stats.ysum[:, j]                                  # (Q|S, W)
        yq_j = stats.ysq[:, j]
        ss = yq_j - ys_j * ys_j / torch.clamp(mj_new, min=1.0)
        fpc = (big_m - mj_new) / torch.clamp(mj_new - 1.0, min=1.0)
        v_local = scale * fpc * torch.clamp(ss, min=0.0)         # Eq. (5) LHS
        yhat_local = scale * ys_j
        eps_vec = slots.eps.to(dtype) if slot_mode else self.eps.to(dtype)
        z_q = slots.z.to(dtype)[:, None] if slot_mode else self.z
        # retired / not-yet-admitted slots never hold a chunk open
        stopped_mask = (state.stopped | ~slots.active) if slot_mode \
            else state.stopped
        # ε_j = ε rule (Theorem 3), error-ratio form: 2 z √v_j <= ε |ŷ_j|
        local_ok_q = 2.0 * z_q * torch.sqrt(torch.clamp(v_local, min=0.0)) <= (
            eps_vec[:, None] * torch.clamp(torch.abs(yhat_local), min=1e-12))
        if slot_mode:
            # per-slot m: each live slot needs >= 2 of its own tuples
            local_ok = torch.all((local_ok_q & (mj_new >= 2.0))
                                 | stopped_mask[:, None], dim=0)
        else:
            local_ok = torch.all(local_ok_q | stopped_mask[:, None], dim=0)
            local_ok = local_ok & (mj_new >= 2.0)
        exhausted_w = (scan_m[j] >= sizes[j]) | state.quarantined[j]
        newly_acc = active & local_ok & ~state.acc_met[j]

        if slot_mode:
            # early close before exhaustion only if every live slot's plan
            # permits it (single-pass, or resource-aware while CPU-bound)
            allow_early = (slots.plan == PLAN_SINGLE_PASS) | (
                (slots.plan == PLAN_RESOURCE_AWARE) & state.cpu_bound)
            early_ok = torch.all(allow_early | stopped_mask)
            close_w = exhausted_w | (local_ok & early_ok)
        else:
            strategy = cfg.strategy
            if strategy in ("chunk_level", "chunk_level_unordered",
                            "holistic"):
                close_w = exhausted_w
            elif strategy == "single_pass":
                close_w = exhausted_w | local_ok
            else:  # resource_aware
                close_w = exhausted_w | (local_ok & state.cpu_bound)
        close_w = close_w & active

        zero_d = torch.zeros((), dtype=dtype, device=dev)
        flag_deltas = coll.merge(dict(
            acc=_zeros((n,), _I32, mj).index_add_(
                0, j, (local_ok & active).to(_I32)),
            cls=_zeros((n,), _I32, mj).index_add_(0, j, close_w.to(_I32)),
            b_eff_total=torch.sum(b_eff).to(_I32),
        ), dict(
            calib_w=torch.where(newly_acc, scan_mj, zero_d),
            newly_w=newly_acc.to(dtype),
        ))
        acc_met = state.acc_met | (flag_deltas["acc"] > 0)
        closed = state.closed | (flag_deltas["cls"] > 0)
        cur = torch.where(close_w, torch.full_like(cur, IDLE), cur)
        calib_cnt_d = torch.sum(flag_deltas["newly_w"])
        calib_sum = state.calib_sum + torch.sum(
            flag_deltas["calib_w"]).to(torch.float32)
        calib_cnt = state.calib_cnt + calib_cnt_d.to(torch.float32)

        # resource monitor: Eq. (4)'s two cost terms for this round
        round_cpu = (flag_deltas["b_eff_total"].to(torch.float32)
                     * self.cost_per_tuple / cfg.cpu_tuple_ops_per_sec
                     / cfg.num_workers)
        round_io = bytes_round.to(torch.float32) / cfg.io_bytes_per_sec
        cpu_bound = round_cpu > round_io

        # budget (t_eval) update — §5.4 rules
        any_acc = calib_cnt_d > 0
        halve = torch.where(cpu_bound, state.first_est, any_acc)
        decay = torch.where(halve, state.decay * 0.5,
                            torch.clamp(state.decay * 2.0, max=1.0))
        base = torch.where(
            calib_cnt > 0, calib_sum / torch.clamp(calib_cnt, min=1.0),
            torch.full((), float(cfg.budget_init), device=dev))
        budget = torch.clamp(base * decay, float(cfg.budget_min),
                             float(cfg.budget_max))
        if slot_mode:
            # adapt t_eval iff some live slot runs the resource-aware plan
            use_adapt = torch.any(slots.active & ~state.stopped
                                  & (slots.plan == PLAN_RESOURCE_AWARE))
            budget = torch.where(use_adapt, budget, state.budget)
            decay = torch.where(use_adapt, decay, state.decay)
        elif cfg.strategy != "resource_aware":
            budget = state.budget      # fixed t_eval for the simpler strategies
            decay = state.decay

        # ---- 5. ESTIMATE -----------------------------------------------------
        if slot_mode:
            # chunk-level slots see only the closed schedule prefix
            base_mask = stats.m > 0                              # (S, N)
            est_mask = torch.where(
                (slots.plan == PLAN_CHUNK_LEVEL)[:, None],
                base_mask & self._closed_prefix_mask(
                    closed, state.schedule)[None], base_mask)
        else:
            strategy = cfg.strategy
            if strategy == "chunk_level":
                est_mask = self._closed_prefix_mask(closed, state.schedule)
            elif strategy == "chunk_level_unordered":
                est_mask = closed              # inspection-paradox-vulnerable
            else:
                est_mask = stats.m > 0
        # coverage-adjusted population: quarantined chunks leave the sample
        # and the universe (N and M shrink to the survivors)
        alive = ~state.quarantined
        est_mask = est_mask & alive
        n_eff = (stats.n_total
                 - torch.sum(state.quarantined.to(_I32))).to(_I32)
        m_eff = (stats.m_total - torch.sum(torch.where(
            state.quarantined, sizes, torch.zeros_like(sizes)))).to(_I32)
        stats_est = stats._replace(
            m=torch.where(est_mask, stats.m, torch.zeros_like(stats.m)),
            ysum=torch.where(est_mask, stats.ysum, zero_d),
            ysq=torch.where(est_mask, stats.ysq, zero_d),
            psum=torch.where(est_mask, stats.psum, zero_d),
            n_total=n_eff, m_total=m_eff)

        sum_t = est.tau_hat(stats_est)
        sum_v, _ = est.var_hat(stats_est)
        cnt_t = est.count_tau_hat(stats_est)
        cnt_v, _ = est.count_var_hat(stats_est)
        need_avg = slot_mode or any(qq.agg == "avg" for qq in self.queries)
        if need_avg:
            avg_t, avg_v, _ = est.avg_estimate(stats_est)

        if slot_mode:
            agg = slots.agg
            estimate = torch.where(agg == AGG_SUM, sum_t,
                                   torch.where(agg == AGG_COUNT, cnt_t, avg_t))
            variance = torch.where(agg == AGG_SUM, sum_v,
                                   torch.where(agg == AGG_COUNT, cnt_v, avg_v))
            # per-slot confidence bounds: estimate ± z_s √var
            half = slots.z.to(dtype) * torch.sqrt(
                torch.clamp(variance, min=0.0))
            lo, hi = estimate - half, estimate + half
            err = est.error_ratio(estimate, lo, hi)
            op = slots.having_op
            decided = est.having_decision_coded(
                lo, hi, op, slots.having_thr.to(dtype))
            stop_now = (err <= eps_vec) | ((op != HAVING_NONE) & (decided != -1))
            if grouped:
                # per-cell estimates over the (S, G, N) rows: the estimators
                # broadcast over leading dims, and a cell with gm == 0 on a
                # chunk is simply not in that cell's sample
                gmask = est_mask[:, None, :]
                gstats_est = BiLevelStats(
                    M=stats.M,
                    m=torch.where(gmask, gm_new, torch.zeros_like(gm_new)),
                    ysum=torch.where(gmask, gys_new, zero_d),
                    ysq=torch.where(gmask, gyq_new, zero_d),
                    psum=torch.where(gmask, gps_new, zero_d),
                    n_total=n_eff, m_total=m_eff)
                g_sum_t = est.tau_hat(gstats_est)
                g_sum_v, _ = est.var_hat(gstats_est)
                g_cnt_t = est.count_tau_hat(gstats_est)
                g_cnt_v, _ = est.count_var_hat(gstats_est)
                g_avg_t, g_avg_v, _ = est.avg_estimate(gstats_est)
                agg_b = agg[:, None]
                g_est = torch.where(agg_b == AGG_SUM, g_sum_t,
                                    torch.where(agg_b == AGG_COUNT, g_cnt_t,
                                                g_avg_t))
                g_var = torch.where(agg_b == AGG_SUM, g_sum_v,
                                    torch.where(agg_b == AGG_COUNT, g_cnt_v,
                                                g_avg_v))
                g_half = slots.z.to(dtype)[:, None] * torch.sqrt(
                    torch.clamp(g_var, min=0.0))
                g_lo, g_hi = g_est - g_half, g_est + g_half
                g_err = est.error_ratio(g_est, g_lo, g_hi)
                g_n = torch.sum(torch.where(gmask, gm_new,
                                            torch.zeros_like(gm_new)),
                                dim=-1, dtype=_I32)
                # grouped stop: the slot's top-K live cells by |estimate|
                # must all meet its eps (ranks by a stable double argsort;
                # ties, such as every dead cell's -inf, keep index order)
                cell_ok = (slots.gact > 0) & (g_n > 0)
                scores = torch.where(cell_ok, torch.abs(g_est),
                                     torch.full_like(g_est, float("-inf")))
                ranks = torch.argsort(
                    torch.argsort(-scores, dim=-1, stable=True), dim=-1,
                    stable=True)
                need_cell = cell_ok & (ranks < slots.gtopk[:, None])
                # discovery guard: with fewer than top_k live cells the rule
                # would hold vacuously (a fresh slot has only __other__
                # live), so such a slot keeps scanning; a store with fewer
                # groups than top_k runs to exhaustion and retires there
                n_live = torch.sum(cell_ok.to(_I32), dim=-1)
                grouped_ok = (torch.all(~need_cell
                                        | (g_err <= eps_vec[:, None]), dim=-1)
                              & (n_live >= slots.gtopk))
                # grouped slots retire on the grouped rule alone (the scalar
                # err describes the base-predicate population)
                stop_now = torch.where(slots.gcol >= 0, grouped_ok, stop_now)
            stopped = state.stopped | stop_now
            all_stopped = torch.all(stopped | ~slots.active)
            n_chunks_rep = torch.sum((scan_m > 0).to(_I32))
            m_tuples_rep = torch.sum(scan_m)
        else:
            pick = {"sum": (sum_t, sum_v), "count": (cnt_t, cnt_v)}
            if need_avg:
                pick["avg"] = (avg_t, avg_v)
            estimate = torch.stack([pick[qq.agg][0][qi]
                                    for qi, qq in enumerate(self.queries)])
            variance = torch.stack([pick[qq.agg][1][qi]
                                    for qi, qq in enumerate(self.queries)])
            lo, hi = est.confidence_bounds(estimate, variance, self.conf)
            err = est.error_ratio(estimate, lo, hi)
            decided = torch.full((q,), -1, dtype=torch.int8, device=dev)
            stop_now = err <= self.eps.to(dtype)
            for qi, qq in enumerate(self.queries):
                if qq.having is not None:
                    d = est.having_decision(lo[qi], hi[qi], qq.having.op,
                                            qq.having.threshold)
                    decided[qi] = d
                    stop_now[qi] = stop_now[qi] | (d != -1)
            stopped = state.stopped | stop_now
            all_stopped = torch.all(stopped)
            n_chunks_rep = stats_est.n
            m_tuples_rep = torch.sum(stats_est.m)

        if not grouped:
            g_est = g_lo = g_hi = g_err = torch.zeros(
                (q, self.group_cells), dtype=dtype, device=dev)
            g_n = torch.zeros((q, self.group_cells), dtype=_I32, device=dev)
        all_closed = torch.all(closed) & (head >= n)
        new_state = EngineState(
            stats=stats, scan_m=scan_m, offset=offset, closed=closed,
            acc_met=acc_met, head=head, cur=cur, budget=budget, decay=decay,
            calib_sum=calib_sum, calib_cnt=calib_cnt,
            first_est=torch.ones((), dtype=torch.bool, device=dev),
            stopped=stopped, round=state.round + 1,
            t_io=state.t_io + round_io, t_cpu=state.t_cpu + round_cpu,
            cpu_bound=cpu_bound, cached_m=state.cached_m,
            raw_touched=raw_touched, cache=cache, schedule=state.schedule,
            quarantined=state.quarantined,
            gm=gm_new, gys=gys_new, gyq=gyq_new, gps=gps_new)
        report = RoundReport(
            estimate=estimate, lo=lo, hi=hi, err=err, decided=decided,
            n_chunks=n_chunks_rep, m_tuples=m_tuples_rep,
            round_io_s=round_io, round_cpu_s=round_cpu,
            tuples_round=flag_deltas["b_eff_total"], bytes_round=bytes_round,
            all_stopped=all_stopped, exhausted=all_closed,
            g_est=g_est, g_lo=g_lo, g_hi=g_hi, g_err=g_err, g_n=g_n,
            g_tal=g_tal)
        return new_state, report


def budget_ladder(config: EngineConfig, m_max: int, b: float) -> int:
    """Snap a fractional t_eval budget to the power-of-two ladder."""
    b = float(np.clip(b, config.budget_min, min(config.budget_max, m_max)))
    return int(2 ** int(np.ceil(np.log2(max(b, 1.0)))))


# ---------------------------------------------------------------------------
# Slot retire / re-admit helpers (workload serving)
# ---------------------------------------------------------------------------

def slot_stats_snapshot(state: EngineState, s: int) -> dict:
    """Host-side copy of slot ``s``'s sufficient-statistics row
    ``{m, ysum, ysq, psum}`` — the same contract as
    :meth:`~repro_torch.core.synopsis.BiLevelSynopsis.seed_slot`, so a
    snapshot slots straight back in through :func:`slot_stats_write`."""
    stats = state.stats
    return dict(m=stats.m[s].cpu().numpy(), ysum=stats.ysum[s].cpu().numpy(),
                ysq=stats.ysq[s].cpu().numpy(),
                psum=stats.psum[s].cpu().numpy())


def slot_stats_fold(state: EngineState, slot_ids) -> dict:
    """Batched fold-out of several slots' rows ``{s: {m, ysum, ysq, psum}}``:
    one device-to-host copy per statistics array, none when ``slot_ids``
    is empty."""
    slot_ids = list(slot_ids)
    if not slot_ids:
        return {}
    stats = state.stats
    m, ysum = stats.m.cpu().numpy(), stats.ysum.cpu().numpy()
    ysq, psum = stats.ysq.cpu().numpy(), stats.psum.cpu().numpy()
    return {s: dict(m=m[s], ysum=ysum[s], ysq=ysq[s], psum=psum[s])
            for s in slot_ids}


def slot_stats_write(stats: BiLevelStats, s: int, seed: Optional[dict],
                     n_chunks: int) -> tuple[BiLevelStats, int]:
    """Write slot ``s``'s statistics row from a seed dict (zeros when
    ``seed`` is None) into copies of the arrays.  Returns ``(new_stats,
    seeded_tuple_count)``.  Host-side, between rounds."""
    dev = stats.ysum.device
    m, ysum = stats.m.clone(), stats.ysum.clone()
    ysq, psum = stats.ysq.clone(), stats.psum.clone()
    if seed is None:
        m[s] = 0
        ysum[s] = 0
        ysq[s] = 0
        psum[s] = 0
        seeded = 0
    else:
        def row(key, like):
            return torch.as_tensor(np.asarray(seed[key]),
                                   device=dev).to(like.dtype)

        m[s] = row("m", m)
        ysum[s] = row("ysum", ysum)
        ysq[s] = row("ysq", ysq)
        psum[s] = row("psum", psum)
        seeded = int(np.asarray(seed["m"]).sum())
    return stats._replace(m=m, ysum=ysum, ysq=ysq, psum=psum), seeded


def zero_group_cells(state: EngineState, s: int,
                     cells=None) -> EngineState:
    """Zero slot ``s``'s per-cell statistics rows (all cells, or the given
    cell indices) in copies of the arrays; host-side, between rounds, and a
    no-op on an ungrouped engine.  Admission gives a new occupant empty
    cells, and a promotion restarts ``__other__`` (its meaning shrank): the
    restarted cell samples the rest of each chunk's permutation, still a
    uniform without-replacement sample."""
    if state.gm.shape[1] == 0:
        return state
    sel = (slice(None) if cells is None
           else torch.as_tensor(list(cells), dtype=torch.long,
                                device=state.gm.device))

    def zero(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        t[s, sel] = 0
        return t

    return state._replace(gm=zero(state.gm), gys=zero(state.gys),
                          gyq=zero(state.gyq), gps=zero(state.gps))


def slot_group_rows(state: EngineState, s: int) -> dict:
    """Host copy of slot ``s``'s per-cell rows ``{gm, gys, gyq, gps}``, each
    ``(G, N)``: per cell the ``{m, ysum, ysq, psum}`` contract of
    :func:`slot_stats_snapshot`."""
    return dict(gm=state.gm[s].cpu().numpy(), gys=state.gys[s].cpu().numpy(),
                gyq=state.gyq[s].cpu().numpy(),
                gps=state.gps[s].cpu().numpy())


def state_from_numpy(state, device=None) -> EngineState:
    """An :class:`EngineState` on ``device`` from any state with the same
    fields holding array-likes (the reference package's state, read with
    ``numpy.asarray``), grouped rows included, so a run can continue in
    this package from another's mid-run state."""
    def t(x):
        return torch.as_tensor(np.array(x), device=device)

    st = state.stats
    stats = BiLevelStats(
        M=t(st.M), m=t(st.m), ysum=t(st.ysum), ysq=t(st.ysq),
        psum=t(st.psum), n_total=int(np.asarray(st.n_total)),
        m_total=int(np.asarray(st.m_total)))
    return EngineState(stats=stats, **{
        f: t(getattr(state, f)) for f in EngineState._fields if f != "stats"})


def quarantine_chunks(state: EngineState, chunk_ids) -> EngineState:
    """Host-side quarantine write (between rounds): mark chunks quarantined
    and closed and zero their statistics columns.

    With the columns zeroed and ESTIMATE substituting the surviving chunk
    count and tuple total, the masked N-chunk estimator sums are bit for
    bit those of a fresh scan over the survivors (adding float zeros is
    exact).  A worker holding a quarantined chunk extracts zero tuples next
    round and releases it, so the scan never stalls."""
    ids = sorted({int(c) for c in chunk_ids})
    if not ids:
        return state
    q = state.quarantined.cpu().numpy()
    ids = np.asarray([j for j in ids if not q[j]], np.int64)
    if ids.size == 0:
        return state
    dev = state.quarantined.device
    sel = torch.as_tensor(ids, device=dev)

    def zero_cols(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        t[..., sel] = 0
        return t

    def mark(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        t[sel] = True
        return t

    stats = state.stats
    state = state._replace(
        quarantined=mark(state.quarantined), closed=mark(state.closed),
        cached_m=zero_cols(state.cached_m),
        stats=stats._replace(m=zero_cols(stats.m),
                             ysum=zero_cols(stats.ysum),
                             ysq=zero_cols(stats.ysq),
                             psum=zero_cols(stats.psum)))
    if state.gm.shape[1] > 0:
        state = state._replace(gm=zero_cols(state.gm),
                               gys=zero_cols(state.gys),
                               gyq=zero_cols(state.gyq),
                               gps=zero_cols(state.gps))
    return state


class _ResidencyMixin:
    """Host-side raw-data feed shared by the engines.

    ``round_data(state)`` is what callers pass as the round step's ``data``:
    the resident packed store under ``residency="packed"``, or a freshly
    assembled bounded slab under ``"stream"`` (claim prediction, prefetcher
    assemble, read-ahead hint for the next schedule positions).  It returns
    ``(state, data)``: streaming assembly is where permanent read failures
    surface, and each one quarantines the lost chunk in the returned state
    instead of raising into the caller's round loop.

    ``coll`` is the engine's :class:`_Collectives`: under several ranks the
    slab holds this rank's workers only, and every host decision that
    steers the round loop (the claims, a quarantine, the decoded fraction,
    a wall-clock stop) is agreed across the ranks before it is acted on."""

    pipeline = None
    tracer = NULL_TRACER
    coll = _Collectives()

    def set_tracer(self, tracer) -> None:
        self.tracer = tracer
        if self.pipeline is not None:
            self.pipeline.tracer = tracer

    def _init_engine(self, store, config: EngineConfig, device) -> np.ndarray:
        """The host wrapper's set-up: ``device`` (CUDA unless the caller
        names another), the residency, this rank's slice of the worker
        speeds and ``m_max``; returns the chunk-size vector."""
        self.device = resolve_device(device)
        self.store = store
        self.config = config
        sizes = self._init_residency(store, config)
        speeds = config.worker_speed or (1.0,) * config.num_workers
        if len(speeds) != config.num_workers:
            raise ValueError("worker_speed needs one factor per worker")
        base, wl = self.coll.my_base(), self._local_workers()
        self.speeds = torch.tensor(speeds[base:base + wl],
                                   dtype=torch.float32, device=self.device)
        self.m_max = int(store.max_chunk_tuples)
        return sizes

    def _local_workers(self) -> int:
        return self.config.num_workers // self.coll.ranks

    def _local(self, state: EngineState) -> EngineState:
        """``state`` with ``cur`` cut to this rank's workers (all of them
        on one device)."""
        if self.coll.ranks == 1:
            return state
        base = self.coll.my_base()
        return state._replace(
            cur=state.cur[base:base + self._local_workers()].clone())

    def budget_ladder(self, b: float) -> int:
        return budget_ladder(self.config, self.m_max, b)

    def _init_residency(self, store, config: EngineConfig) -> np.ndarray:
        """Set up ``self.packed``/``self.pipeline`` for the configured
        residency on ``self.device``; returns the chunk-size vector.  The
        packed store is whole on every rank; a slab holds this rank's
        workers."""
        self.quarantine_log: list[int] = []
        if config.residency == "stream":
            self.packed = None
            self.pipeline = SlabPrefetcher(
                store, num_workers=self._local_workers(),
                row_multiple=config.slab_row_tile,
                lookahead=config.prefetch_lookahead, device=self.device,
                adaptive=config.prefetch_adaptive,
                decoded_cache_bytes=config.decoded_cache_bytes)
            return store.chunk_sizes
        self.packed, sizes = store.packed_device_view(self.device)
        return sizes

    def round_data(self, state: EngineState) -> tuple[EngineState, object]:
        if self.pipeline is None:
            return state, self.packed
        coll = self.coll
        base, wl = coll.my_base(), self.pipeline.num_workers
        with self.tracer.span("assemble"):
            # the claims need every worker's cursor
            j, active, new_head = self.program.plan_claims(
                state, coll.gather_workers(state.cur))
            j = np.asarray(j)[base:base + wl]
            # never read a quarantined chunk: its worker still claims it
            # but extracts b_eff == 0 from a zero slab row
            qn = state.quarantined.cpu().numpy()
            active = np.asarray(active)[base:base + wl] & ~qn[j]
            # lost[w] = 1 + the chunk worker w could not read (0: none)
            lost = np.zeros(wl, np.int32)
            while True:
                try:
                    slab = self.pipeline.assemble(j, active & (lost == 0))
                    break
                except FaultError as e:
                    if e.chunk_id is None:
                        raise
                    hit = (j == int(e.chunk_id)) & active & (lost == 0)
                    if not hit.any():
                        raise
                    lost[hit] = int(e.chunk_id) + 1
            # retries exhausted, CRC mismatch or permanent loss: every rank
            # drops the lost chunks from the population (and from the
            # decoded cache: their bytes are no longer trusted), in global
            # worker order
            lost_all = coll.gather_workers(torch.as_tensor(
                lost, device=state.quarantined.device)).cpu().numpy()
            for c in dict.fromkeys(int(x) - 1 for x in lost_all if x > 0):
                state = quarantine_chunks(state, [c])
                self.drop_decoded_chunks([c])
                self.quarantine_log.append(c)
            # read-ahead follows the state's schedule; quarantined chunks
            # are skipped
            qn = state.quarantined.cpu().numpy()
            nxt = state.schedule.cpu().numpy()[
                new_head:new_head + self.pipeline.lookahead]
            self.pipeline.prefetch(int(p) for p in nxt if not qn[p])
            return state, slab

    def drop_decoded_chunks(self, chunk_ids) -> int:
        """Evict chunks from the prefetcher's decoded cache (quarantine /
        invalidation hook); returns the number actually dropped."""
        if self.pipeline is None or self.pipeline.decoded is None:
            return 0
        return self.pipeline.drop_decoded(chunk_ids)

    def decoded_fraction(self) -> float:
        """Fraction of the store's tuples with decoded blocks cached (the
        Eq. (4) CPU-cost discount input); 0.0 without a decoded cache.
        Under several ranks a chunk counts when any rank has it decoded,
        so every rank reads the same fraction."""
        if self.pipeline is None or self.pipeline.decoded is None:
            return 0.0
        if self.coll.ranks == 1:
            return self.pipeline.decoded_fraction()
        mask = self.coll.maximum(torch.as_tensor(
            self.pipeline.decoded_mask(), dtype=torch.int32,
            device=self.device))
        return self.pipeline.decoded_fraction(mask.cpu().numpy() > 0)

    def agree(self, flag: bool) -> bool:
        """A host decision that ends a round loop (a wall-clock cut), true
        on every rank when it is true on any: the ranks leave the loop
        after the same round."""
        return self.coll.any(flag)

    @staticmethod
    def data_mode(data) -> tuple[str, object]:
        """Split :meth:`round_data`'s result into the round variant and the
        round's data argument: the prefetcher's decoded 4-tuple carries a
        host-side all-decoded flag that picks ``"all"`` over ``"mixed"``;
        anything else is the raw ``"none"`` round."""
        if isinstance(data, tuple) and len(data) == 4:
            raw, dec_slab, mask, all_dec = data
            return ("all" if all_dec else "mixed"), (raw, dec_slab, mask)
        return "none", data

    def close(self) -> None:
        """Stop the prefetcher's reader thread (streaming); idempotent."""
        if self.pipeline is not None:
            self.pipeline.close()


class OLAEngine(_ResidencyMixin):
    """Host-facing single-device engine for a frozen query list."""

    def __init__(self, store, queries: Sequence[Query], config: EngineConfig,
                 schedule: Optional[np.ndarray] = None, device=None):
        sizes = self._init_engine(store, config, device)
        self.program = EngineProgram(
            codec=store.codec, queries=queries, config=config,
            n_chunks=store.num_chunks, m_max=store.max_chunk_tuples,
            chunk_sizes=sizes, schedule=schedule, device=self.device)

    @property
    def queries(self):
        return self.program.queries

    def init_state(self, synopsis_seed: Optional[dict] = None) -> EngineState:
        return self._local(self.program.init_state(synopsis_seed))

    def round_fn(self, b_static: int, decoded_mode: str = "none"):
        """The round step at budget ``b_static`` for the round variant
        ``decoded_mode`` (see :meth:`data_mode`): ``step(state, data,
        speeds) -> (state, report)``."""

        def step(state, data, speeds):
            return self.program.round_body(state, data, speeds, b_static,
                                           self.coll,
                                           decoded_mode=decoded_mode)

        return step

    def run(self, max_rounds: int = 100_000, wall_timeout_s: float = 300.0,
            synopsis_seed: Optional[dict] = None, collect_history: bool = True):
        """Bare driver loop (the δ-interval reporting controller wraps this)."""
        state = self.init_state(synopsis_seed)
        history = []
        t0 = time.perf_counter()
        for _ in range(max_rounds):
            b = self.budget_ladder(float(state.budget))
            state, data = self.round_data(state)
            mode, data = self.data_mode(data)
            state, rep = self.round_fn(b, mode)(state, data, self.speeds)
            if collect_history:
                history.append(RoundReport(*(t.cpu().numpy() for t in rep)))
            if bool(rep.all_stopped) or bool(rep.exhausted):
                break
            if self.agree(time.perf_counter() - t0 > wall_timeout_s):
                break
        return state, history


class SlotOLAEngine(_ResidencyMixin):
    """Host-facing engine whose query plane is a dynamic slot table:
    admitting, retiring or re-targeting a query is a host-side row write
    between rounds.  The workload server
    (:class:`repro_torch.serve.ola_server.OLAWorkloadServer`) owns admission
    policy, synopsis seeding and top-up passes; this class owns the device
    buffers and the round step."""

    def __init__(self, store, max_slots: int, config: EngineConfig,
                 schedule: Optional[np.ndarray] = None,
                 confidence: float = 0.95, device=None):
        sizes = self._init_engine(store, config, device)
        self.program = EngineProgram(
            codec=store.codec, config=config, n_chunks=store.num_chunks,
            m_max=store.max_chunk_tuples, chunk_sizes=sizes,
            schedule=schedule, max_slots=max_slots, confidence=confidence,
            device=self.device)

    @property
    def max_slots(self) -> int:
        return self.program.max_slots

    def init_state(self) -> EngineState:
        return self._local(self.program.init_state())

    def round_fn(self, b_static: int, decoded_mode: str = "none"):
        """The round step at budget ``b_static`` for the round variant
        ``decoded_mode`` (see :meth:`data_mode`): ``step(state, table,
        data, speeds) -> (state, report)``."""

        def step(state, table, data, speeds):
            return self.program.round_body(state, data, speeds, b_static,
                                           self.coll, slots=table,
                                           decoded_mode=decoded_mode)

        return step
