"""The OLA-verify cell: the paper's engine round at production scale
(counterpart of ``repro.launch.verify_cell``).

One engine round (claim → extract → merge → decide → estimate) on the
ranks of a mesh's ``data`` dimension for a production-sized raw metadata
table (4,096 chunks × 65,536 tuples × 6 ASCII columns, 96-byte records,
≈ 25.8 GB raw).  Two store layouts:

* ``replicated`` — the paper's shared-memory model verbatim: every rank
  holds the whole raw store and runs ``EngineProgram.round_body`` with
  :class:`~repro_torch.core.engine.GroupCollectives` over the data group,
  one worker a rank (bit for bit the single-device engine, as
  ``core/engine_spmd.py``).  On a CUDA device its EXTRACT is the fused
  ``slot_extract`` kernel.
* ``sharded`` — chunks sharded over the data ranks with per-shard queues:
  rank ``d`` holds only its contiguous ``N/D`` chunks and processes them
  in its own committed random order (``random_chunk_order(seed + 17·d,
  N/D) + d·N/D``).  Chunk inclusion is still decided before execution, so
  the no-inspection-paradox argument survives; the single global prefix
  becomes a union of per-shard prefixes (stratified SRSWOR over the
  committed orders; Eq. (1)/(3) apply unchanged).  Raw bytes a rank drop
  by the data-axis factor, and claims are shard-local.

The sharded round is an SPMD program with explicit collectives, the
counterpart of the reference's ``shard_map``: the engine state stays
replicated (every rank holds it whole and advances it by merged deltas),
the reference's five ``psum``s become ``all_reduce(SUM)`` on the data
group, packed two at a time by wire dtype
(``GroupCollectives.merge``).  Each element of the summed deltas has
exactly one non-zero contributor (a chunk belongs to one shard), so the
merged state is exact at any rank count.  It decodes with the codec's
plain ``decode_ref`` and evaluates with the compiled queries, as the
reference does (no kernel), and sums a window's rows with
``kernels/ref.py::sum_last``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import estimators as est
from repro_torch.core.engine import (
    EngineConfig,
    EngineProgram,
    EngineState,
    GroupCollectives,
    RoundReport,
)
from repro_torch.core.engine_spmd import mesh_group
from repro_torch.core.queries import Column, Having, Query, Range, TRUE
from repro_torch.data.formats import AsciiFixedFormat
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import sum_last
from repro_torch.sampling.permutation import (
    permutation_window_dyn,
    random_chunk_order,
)
from repro_torch.tree import tree_map

_I32 = torch.int32


def production_verify_program(n_chunks: int = 4096, m_per_chunk: int = 65536,
                              num_cols: int = 6, workers: int = 256,
                              budget: int = 256, device=None):
    """``(program, config, codec)`` of the production verify table: three
    HAVING queries at ε = 0.05 (the engine's device is CUDA unless
    ``device`` names another)."""
    codec = AsciiFixedFormat(num_cols)
    queries = [
        Query(agg="avg", expr=Column(1), pred=TRUE, having=Having(">", 75.0),
              epsilon=0.05, name="avg_quality"),
        Query(agg="avg", expr=Column(3), pred=TRUE, having=Having("<", 10.0),
              epsilon=0.05, name="avg_dup"),
        Query(agg="count", pred=Range(0, 0.0, 16.0), having=Having("<", 1e6),
              epsilon=0.05, name="short_docs"),
    ]
    cfg = EngineConfig(num_workers=workers, strategy="resource_aware",
                       budget_init=budget, seed=0)
    sizes = np.full(n_chunks, m_per_chunk, np.int64)
    program = EngineProgram(codec=codec, queries=queries, config=cfg,
                            n_chunks=n_chunks, m_max=m_per_chunk,
                            chunk_sizes=sizes, device=device)
    return program, cfg, codec


def shard_schedules(seed: int, n_chunks: int, n_dev: int) -> np.ndarray:
    """``(D, N/D)`` committed per-shard orders: row ``d`` permutes shard
    ``d``'s chunk range."""
    nl = n_chunks // n_dev
    return np.stack([random_chunk_order(seed + 17 * d, nl) + d * nl
                     for d in range(n_dev)]).astype(np.int32)


def _one_at(n: int, j: torch.Tensor, value: torch.Tensor,
            lead: tuple = ()) -> torch.Tensor:
    """Zeros of shape ``lead + (n,)`` with ``value`` (shape ``lead``) at
    position ``j`` of the last dim."""
    out = torch.zeros(lead + (n,), dtype=value.dtype, device=value.device)
    out[..., j] = value
    return out


def _sharded_round(program: EngineProgram, n_dev: int, budget: int,
                   coll: GroupCollectives):
    """Per-shard-queue engine round for this rank (its chunks, the first of
    its workers' speeds): ``round_step(state, packed_local, speeds_local)
    -> (state, report)``.

    The rank's current/next chunk is *derived* from the replicated state
    (the open chunk in its range, else its local schedule at its closed
    count), so no new engine state is needed and checkpointing is
    unchanged."""
    n = program.n_chunks
    if n % n_dev:
        raise ValueError(f"{n} chunks do not divide over {n_dev} ranks")
    nl = n // n_dev
    d = coll.rank
    dev = program.device
    sched = torch.as_tensor(shard_schedules(program.config.seed, n, n_dev)[d],
                            device=dev)
    mine = (torch.arange(n, device=dev) // nl) == d
    z = program.z
    q = len(program.queries)
    having = [(qq.having.op, float(qq.having.threshold))
              for qq in program.queries]
    cfg = program.config

    def round_step(state: EngineState, packed_local: torch.Tensor,
                   speeds_local: torch.Tensor):
        dtype = state.stats.ysum.dtype
        sizes = state.stats.M

        open_mine = (state.stats.m > 0) & ~state.closed & mine
        has_open = torch.any(open_mine)
        local_head = torch.sum((state.closed & mine).to(_I32))
        nxt = sched[torch.clamp(local_head, 0, nl - 1)]
        j = torch.where(has_open, torch.argmax(open_mine.to(_I32)),
                        nxt.to(torch.int64))
        active = has_open | (local_head < nl)

        mj = sizes[j]
        off = state.offset[j]
        m_before = state.stats.m[j]
        b_eff = torch.minimum(
            torch.floor(budget * speeds_local[0]).to(_I32),
            torch.clamp(mj - m_before, min=0).to(_I32))
        b_eff = torch.where(active, b_eff, torch.zeros_like(b_eff))

        idx = permutation_window_dyn(program.seeds[j], off, budget, mj,
                                     program.m_max)
        raw = packed_local[j - d * nl][idx]                     # local slab
        cols = program.codec.decode_ref(raw)
        x, pr = program.evaluate(cols)                          # (Q, B)
        valid = (torch.arange(budget, device=dev) < b_eff).to(dtype)
        x = x.to(dtype) * valid
        pr = pr.to(dtype) * valid

        af = active.to(_I32)
        afd = af.to(dtype)
        taken = b_eff * af
        newly_raw = active & (b_eff > 0) & ~state.raw_touched[j]
        deltas = coll.merge(dict(
            dm=_one_at(n, j, taken),
            dys=_one_at(n, j, sum_last(x) * afd, (q,)),
            dyq=_one_at(n, j, sum_last(x * x) * afd, (q,)),
            dps=_one_at(n, j, sum_last(pr) * afd, (q,)),
            raw=_one_at(n, j, newly_raw.to(_I32)),
            bytes=torch.where(newly_raw, program.chunk_bytes[j],
                              torch.zeros_like(program.chunk_bytes[j])),
            tuples=b_eff))
        stats = state.stats._replace(
            m=state.stats.m + deltas["dm"],
            ysum=state.stats.ysum + deltas["dys"],
            ysq=state.stats.ysq + deltas["dyq"],
            psum=state.stats.psum + deltas["dps"])
        offset = state.offset + deltas["dm"]
        raw_touched = state.raw_touched | (deltas["raw"] > 0)
        bytes_round = deltas["bytes"]
        tuples = deltas["tuples"]

        # local accuracy (Theorem 3) on my chunk; close + io accounting
        mj_new = stats.m[j].to(dtype)
        big_m = sizes[j].to(dtype)
        scale = big_m / torch.clamp(mj_new, min=1.0)
        ys_j = stats.ysum[:, j]
        ss = stats.ysq[:, j] - ys_j * ys_j / torch.clamp(mj_new, min=1.0)
        fpc = (big_m - mj_new) / torch.clamp(mj_new - 1.0, min=1.0)
        v_local = scale * fpc * torch.clamp(ss, min=0.0)
        yhat = scale * ys_j
        local_ok = torch.all(
            2.0 * z * torch.sqrt(torch.clamp(v_local, min=0.0))
            <= program.eps.to(dtype) * torch.clamp(torch.abs(yhat),
                                                   min=1e-12))
        local_ok = local_ok & (mj_new >= 2.0)
        exhausted = stats.m[j] >= sizes[j]
        close = active & (exhausted | (local_ok & state.cpu_bound))
        closed = state.closed | (coll.merge(dict(
            c=_one_at(n, j, close.to(_I32))))["c"] > 0)
        round_cpu = (tuples.to(torch.float32) * program.cost_per_tuple
                     / cfg.cpu_tuple_ops_per_sec / cfg.num_workers)
        round_io = bytes_round.to(torch.float32) / cfg.io_bytes_per_sec

        # global estimate over the union of per-shard prefixes
        mask = stats.m > 0
        zero = torch.zeros((), dtype=dtype, device=dev)
        stats_est = stats._replace(
            m=torch.where(mask, stats.m, torch.zeros_like(stats.m)),
            ysum=torch.where(mask[None], stats.ysum, zero),
            ysq=torch.where(mask[None], stats.ysq, zero),
            psum=torch.where(mask[None], stats.psum, zero))
        avg_t, avg_v, _ = est.avg_estimate(stats_est)
        cnt_t = est.count_tau_hat(stats_est)
        cnt_v, _ = est.count_var_hat(stats_est)
        estimate = torch.stack([avg_t[0], avg_t[1], cnt_t[2]])
        variance = torch.stack([avg_v[0], avg_v[1], cnt_v[2]])
        lo, hi = est.confidence_bounds(estimate, variance, program.conf)
        err = est.error_ratio(estimate, lo, hi)
        decided = torch.stack([est.having_decision(lo[i], hi[i], op, t)
                               for i, (op, t) in enumerate(having)])
        stopped = (state.stopped | (err <= program.eps.to(dtype))
                   | (decided != -1))

        new_state = state._replace(
            stats=stats, scan_m=state.scan_m + deltas["dm"],
            offset=offset, closed=closed, head=state.head + 1,
            first_est=torch.ones_like(state.first_est), stopped=stopped,
            round=state.round + 1, t_io=state.t_io + round_io,
            t_cpu=state.t_cpu + round_cpu, cpu_bound=round_cpu > round_io,
            raw_touched=raw_touched)
        # grouped plane is zero-width here (max_groups == 0)
        gz = torch.zeros((q, program.group_cells), dtype=dtype, device=dev)
        report = RoundReport(
            estimate=estimate, lo=lo, hi=hi, err=err, decided=decided,
            n_chunks=stats_est.n, m_tuples=torch.sum(stats_est.m),
            round_io_s=round_io, round_cpu_s=round_cpu, tuples_round=tuples,
            bytes_round=bytes_round, all_stopped=torch.all(stopped),
            exhausted=torch.all(closed),
            g_est=gz, g_lo=gz, g_hi=gz, g_err=gz,
            g_n=torch.zeros((q, program.group_cells), dtype=_I32,
                            device=dev),
            g_tal=torch.zeros((q, 3, program.tally_buckets), dtype=dtype,
                              device=dev))
        return new_state, report

    round_step.coll = coll
    return round_step


def build_verify_cell(mesh, layout: str = "replicated", budget: int = 256,
                      program: Optional[EngineProgram] = None, device=None):
    """-> ``(step, args, program)``: this rank's round
    ``step(state, packed, speeds) -> (state, report)`` for ``layout``
    (``step.coll``: its collectives), the
    abstract arguments (``launch.steps.ArgSpec``: the replicated state with
    ``cur`` cut to this rank's workers, the packed store, whole or this
    rank's ``N/D`` chunks, the workers' speeds) and the program (the
    production one with one worker a rank unless ``program`` is given).
    ``device`` is where the rank's tensors live (CUDA unless named)."""
    from repro_torch.distributed.sharding import named
    from repro_torch.launch.steps import ArgSpec

    if layout not in ("replicated", "sharded"):
        raise ValueError(f"unknown layout {layout!r}")
    group, rank, n_dev = mesh_group(mesh)
    dev = resolve_device(device)
    if program is None:
        program, _, _ = production_verify_program(budget=budget,
                                                  workers=n_dev, device=dev)
    cfg = program.config
    if cfg.num_workers % n_dev:
        raise ValueError(f"num_workers={cfg.num_workers} must divide over "
                         f"data axis size {n_dev}")
    wpd = cfg.num_workers // n_dev
    coll = GroupCollectives(group, rank, n_dev, wpd, dev)
    n, m, rb = program.n_chunks, program.m_max, program.codec.record_bytes

    if layout == "replicated":
        def step(state, packed, speeds):
            return program.round_body(state, packed, speeds, budget, coll)

        step.coll = coll

        packed_in = ArgSpec((n, m, rb), torch.uint8, named(mesh, ()))
    else:
        step = _sharded_round(program, n_dev, budget, coll)
        packed_in = ArgSpec((n, m, rb), torch.uint8, named(mesh, ("data",)))
    speeds_in = ArgSpec((cfg.num_workers,), torch.float32,
                        named(mesh, ("data",)))
    rep = named(mesh, ())
    state_in = tree_map(
        lambda t: (ArgSpec(tuple(t.shape), t.dtype, rep)
                   if isinstance(t, torch.Tensor) else t),
        local_state(program, rank, wpd))
    return step, (state_in, packed_in, speeds_in), program


def local_state(program: EngineProgram, rank: int,
                workers_per_rank: int = 1) -> EngineState:
    """The initial replicated state with ``cur`` cut to ``rank``'s
    workers."""
    state = program.init_state()
    lo = rank * workers_per_rank
    return state._replace(cur=state.cur[lo:lo + workers_per_rank].clone())
