#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs a CUDA device and ``nvcc``; exits non-zero, printing no result, when
either is missing or any phase fails.  Phases:

1. build     — compile every ``src/repro_torch/csrc/*.cu`` with nvcc for
               sm_90a (one process per source, all started together).
2. kernel    — each kernel against its plain PyTorch version on the card at
               the main path's shapes (W=4 workers, C=16 columns, S=8 slots,
               B in {8, 64, 4096}, cache cap 128), with the tolerance stated
               below, and three equalities bit for bit: the slab kernel on
               chunks ``jw`` == the packed kernel on those ``jw``; the
               decoded kernel fed by ``extract_parse`` == the slab kernel on
               the raw rows; a mixed pair with complementary budgets == the
               single kernel.
3. server    — the deployment: the paper's synthetic dataset (§7.1; 16
               Zipf columns, column k with s = 0.25·k) as 256-byte ASCII
               records, 8,388,608 tuples (2 GiB) in 128 chunks of 65,536,
               packed on the card; EngineConfig(num_workers=4,
               strategy="resource_aware", seed=7), ServerOptions(max_slots=8,
               synopsis_budget_tuples=4096); eight queries arriving as a
               Poisson stream.  Every estimate must lie within 3·ε (relative)
               of its exact float64 answer, and the kernel must have launched
               once per engine round.
4. parity    — the port on the card and on the CPU, on the small workload of
               ``examples/serve_ola_workload.py``, must give identical integer
               engine state every round and identical per-query outcomes.
5. stream parity — the same workload at engine level (SlotOLAEngine,
               mid-scan admission) four ways: packed on the card, streamed
               with the decoded cache off and with a budget of two decoded
               chunks (mixed rounds, evictions) on the card, streamed on the
               CPU.  Integer state identical every round; the three card
               runs' float state bit for bit equal.
6. stream deployment — the deployment's store written to disk (128 chunk
               files) and served with residency="stream" and a 1 GiB
               decoded cache: every answer within 3·ε, slab-kernel +
               decoded-kernel launches == rounds + mixed rounds,
               extract_parse launches == decoded fills, peak device memory
               below 512 MiB (printed beside the packed run's).
7. times     — each kernel's time per launch beside its bound and the plain
               version's time, the mean server round, and the kernel's share
               of round time, each beside the card's name and power limit.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.core.engine import EngineConfig, SlotOLAEngine  # noqa: E402
from repro_torch.core.queries import (  # noqa: E402
    And, Column, Having, Linear, Query, Range, empty_slot_table, encode_slot,
    linear_plan, slot_table_set)
from repro_torch.data.chunkstore import ChunkStore  # noqa: E402
from repro_torch.data.generator import (  # noqa: E402
    make_synthetic_zipf, store_dataset)
from repro_torch.data.pipeline import peak_host_rss_bytes  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.extract_parse import extract_parse_cuda  # noqa: E402
from repro_torch.kernels.ref import slot_extract_ref  # noqa: E402
from repro_torch.kernels.slot_extract import slot_extract_cuda  # noqa: E402
from repro_torch.kernels.slot_extract_stream import (  # noqa: E402
    slot_eval_decoded_cuda, slot_extract_stream_cuda)
from repro_torch.sampling.permutation import (  # noqa: E402
    chunk_seed, permutation_window_dyn)
from repro_torch.serve.ola_server import (  # noqa: E402
    OLAWorkloadServer, ServerOptions, poisson_workload)

# the deployment (see the module docstring)
NUM_TUPLES = 8_388_608
NUM_CHUNKS = 128
NUM_COLS = 16
DATA_SEED = 0
ARRIVAL_SEED = 11
ARRIVALS_PER_MODEL_S = 20.0
ENGINE = dict(num_workers=4, strategy="resource_aware", seed=7)
OPTIONS = dict(max_slots=8, synopsis_budget_tuples=4096)
DECODED_CACHE_BYTES = 1 << 30       # the stream deployment's decoded cache
STREAM_PEAK_LIMIT = 512 << 20       # its device memory must stay below this
CACHE_CAP = 128                     # the server's synopsis cache rows per chunk
PROFILE_ROUNDS = 200                # rounds of each deployment profiled

KERNELS = (slot_extract_cuda, slot_extract_stream_cuda,
           slot_eval_decoded_cuda, extract_parse_cuda)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__.removesuffix("_cuda"): k.launches for k in KERNELS}

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and the float32
# rate outside the tensor cores, which the kernel's integer and float
# arithmetic runs on
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
FIELD_BYTES = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- data ----
def build_store(num_tuples: int, num_chunks: int, num_cols: int):
    """(values (T, C) float64, ASCII ChunkStore); chunks encode in parallel."""
    values = make_synthetic_zipf(num_tuples=num_tuples, num_cols=num_cols,
                                 seed=DATA_SEED)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        store = store_dataset(values, num_chunks=num_chunks, fmt="ascii",
                              encode_map=pool.map)
    return values, store


def deployment_queries(values: np.ndarray) -> list[Query]:
    """The serve_ola_workload.py mix widened to all columns, plus three
    more: a selective COUNT with a tight ε, a selective AVG, and a SUM of
    one column under a two-column predicate."""
    c = values.shape[1]
    coef = tuple(1.0 / (k + 1) for k in range(c))
    lin = values @ np.asarray(coef)
    having_sel = values[:, 0] < 6e7
    # threshold 7% above the true value: the verdict (true) needs a CI
    # tighter than that margin
    thr = 1.07 * float(lin[having_sel].sum())
    return [
        Query(agg="sum", expr=Linear(coef), epsilon=0.05, name="sum-all"),
        Query(agg="count", pred=Range(0, 0.0, 4e7), epsilon=0.08,
              name="count-sel"),
        Query(agg="sum", expr=Linear(coef), pred=Range(0, 0.0, 6e7),
              having=Having("<", thr), epsilon=0.05, name="having-verify"),
        Query(agg="avg", expr=Linear(coef), epsilon=0.05, name="avg-all"),
        Query(agg="sum", expr=Linear(coef), epsilon=0.03, name="sum-tight"),
        Query(agg="count", pred=Range(0, 0.0, 2e7), epsilon=0.02,
              name="count-sel-tight"),
        Query(agg="avg", expr=Linear(coef), pred=Range(1, 0.0, 5e7),
              epsilon=0.04, name="avg-sel"),
        Query(agg="sum", expr=Column(3),
              pred=And((Range(2, 1e7, 9e7), Range(5, 0.0, 8e7))),
              epsilon=0.05, name="sum-col3"),
    ]


def exact_answer(values: np.ndarray, q: Query) -> float:
    """The query's exact answer over ``values`` in float64 numpy."""
    plan = linear_plan([q], values.shape[1])
    lo = plan.lo[0].astype(np.float64)
    hi = plan.hi[0].astype(np.float64)
    sel = np.all((values >= lo) & (values < hi), axis=1)
    x = values @ plan.coeffs[0].astype(np.float64)
    if q.agg == "count":
        return float(sel.sum())
    if q.agg == "sum":
        return float(x[sel].sum())
    return float(x[sel].mean())


# --------------------------------------------------------------- build ----
def phase_build() -> dict:
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[build] {len(secs)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k}.cu {v:.2f} s" for k, v in secs.items()))
    for name, rec in _build.BUILD_LOG.items():
        for line in rec["nvcc"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return secs


# -------------------------------------------------------------- kernel ----
def kernel_inputs(packed: torch.Tensor, sizes: np.ndarray, b: int,
                  rng: np.random.Generator, w: int = 4):
    """One round's kernel inputs at width ``b``: W random chunks, their
    permutation windows at random cursors, unequal budgets (one worker
    idle), and an 8-slot plan with non-unit weights, two gated-off slots
    and three COUNT slots.  Range bounds sit 500 away from any value of
    the dataset's value grid, so no predicate rides a parse rounding."""
    dev = packed.device
    n, m_max, rec = packed.shape
    c = rec // FIELD_BYTES
    jw = rng.choice(n, size=w, replace=False)
    off = rng.integers(0, sizes[jw])
    seeds = chunk_seed(7, torch.as_tensor(jw, device=dev))
    idx = permutation_window_dyn(seeds, torch.as_tensor(off, device=dev), b,
                                 torch.as_tensor(sizes[jw], device=dev),
                                 m_max)
    b_eff = np.asarray([b, max(b - 3, 1), max(b // 2, 1), 0])[:w]
    s = 8
    coeffs = np.zeros((s, c), np.float32)
    lo = np.full((s, c), -np.inf, np.float32)
    hi = np.full((s, c), np.inf, np.float32)
    coeffs[0] = 1.0 / np.arange(1, c + 1)          # SUM over all columns
    hi[1, 0] = 4.00005e7                           # COUNT, selective
    coeffs[2, :4] = (1.0, 0.5, 0.25, 2.0)          # SUM under two ranges
    lo[2, 1], hi[2, 3] = 1.00005e7, 9.00005e7
    coeffs[3] = 1.0                                # gated off
    coeffs[4, 5] = 3.0                             # SUM, weight 0.5
    lo[5, 2] = 2.00005e7                           # COUNT, weight 0.3
    lo[6, 0] = 5.00005e7                           # COUNT, gated off
    coeffs[7, 3] = 1.0                             # SUM, weight 0.77
    hi[7, 6] = 6.00005e7
    is_count = np.asarray([0, 1, 0, 0, 0, 1, 1, 0], np.float32)
    gate = np.asarray([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
    weights = np.asarray([1, 1, 1, 1, 0.5, 0.3, 1, 0.77], np.float32)

    def i32(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(
            torch.int32).contiguous()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return (packed, i32(jw), idx.to(torch.int32).contiguous(), i32(b_eff),
            f32(coeffs), f32(lo), f32(hi), f32(is_count), f32(gate),
            f32(weights))


# Tolerances of the kernel against its plain version.  cols: the kernel
# parses by int32 Horner then one f32 conversion; the plain version sums
# per-digit terms in f32, which rounds at every step above 2^24, so the two
# differ by a few ulp: |a - b| <= 2^-21·|b| + 1e-6.  Sum lanes: every term
# is non-negative (non-negative data, coefficients and indicators), the
# kernel sums rows in another order (blocks, warps, shuffles) and its terms
# carry the few-ulp parse difference, so |a - b| <= (2B + 16)·2^-24·|b|
# (recursive-summation bound for both sides plus the term error).  The m
# lane counts rows and must be equal.
def check_kernel(inputs, return_cols: bool) -> dict:
    packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate, wts = inputs
    b = idx.shape[1]
    got_stats, got_cols = slot_extract_cuda(
        packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate, wts,
        return_cols=return_cols)
    ref_stats, ref_cols = slot_extract_ref(
        packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate,
        num_cols=coeffs.shape[1], return_cols=return_cols, weights=wts)
    torch.cuda.synchronize()
    gs, rs = got_stats.cpu().numpy(), ref_stats.cpu().numpy()
    if not np.array_equal(gs[..., 0], rs[..., 0]):
        raise AssertionError(f"B={b}: m lane differs:\n{gs[..., 0]}\n"
                             f"{rs[..., 0]}")
    rtol = (2 * b + 16) * 2.0 ** -24
    bad = np.abs(gs[..., 1:] - rs[..., 1:]) > rtol * np.abs(rs[..., 1:])
    if bad.any():
        raise AssertionError(f"B={b}: sum lanes differ beyond rtol={rtol:.3g}"
                             f" at {np.argwhere(bad)[:5].tolist()}")
    rel = float(np.max(np.abs(gs[..., 1:] - rs[..., 1:])
                       / np.maximum(np.abs(rs[..., 1:]), 1e-30)))
    out = {"B": b, "return_cols": return_cols, "max_rel_err_sums": rel,
           "rtol_sums": rtol, "max_abs_err_cols": None}
    if return_cols:
        gc, rc = got_cols.cpu().numpy(), ref_cols.cpu().numpy()
        lim = 2.0 ** -21 * np.abs(rc) + 1e-6
        if (np.abs(gc - rc) > lim).any():
            raise AssertionError(f"B={b}: cols differ beyond 2^-21·|v|+1e-6")
        out["max_abs_err_cols"] = float(np.max(np.abs(gc - rc)))
    return out


def phase_kernel(packed: torch.Tensor, sizes: np.ndarray) -> list[dict]:
    rng = np.random.default_rng(3)
    rows = []
    for b in (8, 64, 4096):
        inputs = kernel_inputs(packed, sizes, b, rng)
        for rc in (False, True):
            r = check_kernel(inputs, rc)
            rows.append(r)
            log(f"[kernel] slot_extract B={b} return_cols={rc}: m lane equal;"
                f" sums max rel err {r['max_rel_err_sums']:.3g} (rtol "
                f"{r['rtol_sums']:.3g}); cols max abs err "
                f"{r['max_abs_err_cols']}")
    return rows


def ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest distance of ``got`` from ``want`` in float32 ulps of want."""
    spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - want) / spacing,
                        initial=0.0))


def check_sums(got: np.ndarray, want: np.ndarray, b: int, what: str) -> float:
    """The m lane equal, the sum lanes within (2B+16)·2^-24 relative (see
    check_kernel); returns the largest relative error of the sums."""
    if not np.array_equal(got[..., 0], want[..., 0]):
        raise AssertionError(f"{what} B={b}: m lane differs")
    rtol = (2 * b + 16) * 2.0 ** -24
    err = np.abs(got[..., 1:] - want[..., 1:])
    if (err > rtol * np.abs(want[..., 1:])).any():
        raise AssertionError(f"{what} B={b}: sum lanes differ beyond "
                             f"rtol={rtol:.3g}")
    return float(np.max(err / np.maximum(np.abs(want[..., 1:]), 1e-30)))


def stream_inputs(inputs, m_before=(0, 5, 100, 127)):
    """The slab kernels' view of one round's packed-kernel inputs: the slab
    holds chunk jw[w] at row w (all 65,536 rows), plus scan positions."""
    packed, jw, idx, b_eff, *plan = inputs
    slab = packed[jw.long()].contiguous()
    mb = torch.tensor(m_before, dtype=torch.int32, device=packed.device)
    return slab, idx, b_eff, plan, mb


# The slab kernels against their plain versions (tolerances as for
# slot_extract: m lane equal, sums within (2B+16)·2^-24; decoded values,
# i.e. cache rows and extract_parse's output, within one float32 ulp of the
# plain parse: both round each field's value once or twice from the same
# digits), and the three bitwise equalities of the module docstring.
def phase_stream_kernels(packed: torch.Tensor, sizes: np.ndarray) -> dict:
    rng = np.random.default_rng(13)
    out = {"stream": [], "decoded": [], "parse": []}
    c = packed.shape[2] // FIELD_BYTES
    for b in (8, 64, 4096):
        inputs = kernel_inputs(packed, sizes, b, rng)
        slab, idx, b_eff, plan, mb = stream_inputs(inputs)
        coeffs, lo, hi, isc, gate, wts = plan
        args = (idx, b_eff, coeffs, lo, hi, isc, gate, wts, mb)
        got, rows = slot_extract_stream_cuda(slab, *args,
                                             cache_cap=CACHE_CAP)
        want = kref.slot_extract_stream_ref(slab, idx, b_eff, coeffs, lo, hi,
                                            isc, gate, num_cols=c,
                                            weights=wts)
        want_rows = kref.stream_cache_rows_ref(slab, idx, b_eff, mb,
                                               CACHE_CAP, c)
        w, r, rec = slab.shape
        dec = extract_parse_cuda(slab.reshape(w * r, rec), c)
        plain_dec = kref.parse_ascii_ref(slab.reshape(w * r, rec), c)
        dstats, drows = slot_eval_decoded_cuda(dec.reshape(w, r, c), *args,
                                               cache_cap=CACHE_CAP)
        dwant = kref.slot_eval_decoded_ref(dec.reshape(w, r, c), idx, b_eff,
                                           coeffs, lo, hi, isc, gate,
                                           weights=wts)
        dwant_rows = kref.window_cache_rows_ref(
            kref.gather_window(dec.reshape(w, r, c), idx), b_eff, mb,
            CACHE_CAP)
        packed_stats, _ = slot_extract_cuda(*inputs)
        is_dec = torch.tensor([True, False, False, True], device=slab.device)
        b_raw = torch.where(is_dec, torch.zeros_like(b_eff), b_eff)
        m1, mrows1 = slot_extract_stream_cuda(slab, idx, b_raw, *args[2:],
                                              cache_cap=CACHE_CAP)
        m2, mrows2 = slot_eval_decoded_cuda(dec.reshape(w, r, c), idx,
                                            b_eff - b_raw, *args[2:],
                                            cache_cap=CACHE_CAP)
        torch.cuda.synchronize()
        h = {k: v.cpu().numpy() for k, v in dict(
            got=got, rows=rows, want=want, want_rows=want_rows, dec=dec,
            plain_dec=plain_dec, dstats=dstats, drows=drows, dwant=dwant,
            dwant_rows=dwant_rows, packed=packed_stats, mixed=m1 + m2,
            mixed_rows=mrows1 + mrows2).items()}
        rel = check_sums(h["got"], h["want"], b, "slot_extract_stream")
        rows_ulps = ulps(h["rows"], h["want_rows"])
        if rows_ulps > 1.0:
            raise AssertionError(f"B={b}: cache rows {rows_ulps} ulp from "
                                 "the plain parse")
        drel = check_sums(h["dstats"], h["dwant"], b, "slot_eval_decoded")
        if not np.array_equal(h["drows"], h["dwant_rows"]):
            raise AssertionError(f"B={b}: decoded cache rows differ")
        parse_ulps = ulps(h["dec"], h["plain_dec"])
        if parse_ulps > 1.0:
            raise AssertionError(f"extract_parse {parse_ulps} ulp from the "
                                 "plain parse")
        # the three equalities, bit for bit (±0 compare equal)
        if not np.array_equal(h["got"], h["packed"]):
            raise AssertionError(f"B={b}: slab kernel != packed kernel")
        if not (np.array_equal(h["dstats"], h["got"])
                and np.array_equal(h["drows"], h["rows"])):
            raise AssertionError(f"B={b}: decoded kernel != slab kernel")
        if not (np.array_equal(h["mixed"], h["got"])
                and np.array_equal(h["mixed_rows"], h["rows"])):
            raise AssertionError(f"B={b}: mixed pair != single kernel")
        out["stream"].append(dict(
            B=b, max_rel_err_sums=rel, cache_rows_ulps=rows_ulps,
            max_abs_err=float(np.max(np.abs(h["rows"] - h["want_rows"])))))
        out["decoded"].append(dict(
            B=b, max_rel_err_sums=drel, max_abs_err=float(
                np.max(np.abs(h["drows"] - h["dwant_rows"])))))
        out["parse"].append(dict(
            rows=w * r, ulps=parse_ulps,
            max_abs_err=float(np.max(np.abs(h["dec"] - h["plain_dec"])))))
        log(f"[kernel] B={b}: slot_extract_stream sums max rel err "
            f"{rel:.3g} (rtol {(2 * b + 16) * 2.0 ** -24:.3g}), cache rows "
            f"within {rows_ulps:.0f} ulp; slot_eval_decoded sums max rel err "
            f"{drel:.3g}, cache rows exact; extract_parse of {w * r} rows "
            f"within {parse_ulps:.0f} ulp (max abs err "
            f"{out['parse'][-1]['max_abs_err']})")
        log(f"[kernel] B={b}: bitwise: slab == packed, decoded(extract_parse)"
            f" == slab, mixed pair == single (stats and cache rows)")
        del slab, dec, plain_dec
    return out


# -------------------------------------------------------------- server ----
def run_server(store, queries, arrivals, device, on_round=None):
    server = OLAWorkloadServer(store, EngineConfig(**ENGINE),
                               options=ServerOptions(**OPTIONS),
                               device=device)
    for q, at in zip(queries, arrivals):
        server.submit(q, arrival_t=at)
    return server


def phase_server(store, values) -> dict:
    queries = deployment_queries(values)
    arrivals = [at for _, at in poisson_workload(
        queries, ARRIVALS_PER_MODEL_S, seed=ARRIVAL_SEED)]
    exact = {q.name: exact_answer(values, q) for q in queries}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = run_server(store, queries, arrivals, "cuda")
    torch.cuda.synchronize()
    log(f"[server] store packed on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    # the B of every round: the ladder rung of the budget before it
    rungs = [server.engine.budget_ladder(float(server.state.budget))]

    def on_round(srv):
        rungs.append(srv.engine.budget_ladder(float(srv.state.budget)))

    reset_launches()
    t0 = time.perf_counter()
    results = server.run(on_round=on_round)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["slot_extract"]
    peak = torch.cuda.max_memory_allocated()
    server.close()
    rungs = rungs[:server.rounds]
    if server.truncated or len(results) != len(queries):
        raise AssertionError("server run truncated")
    log(f"[server] {'query':>16} {'plan':>14} {'estimate':>14} "
        f"{'exact':>14} {'dev/eps':>7} {'err':>7} {'dec':>3} "
        f"{'rounds':>6} {'seen':>8} {'seeded':>6}")
    failures = []
    for r, q in zip(results, queries):
        ex = exact[q.name]
        dev = abs(r.estimate - ex) / abs(ex)
        ok = np.isfinite(r.estimate) and dev <= 3 * q.epsilon
        if not ok:
            failures.append(q.name)
        log(f"[server] {r.name:>16} {r.plan:>14} {r.estimate:14.7g} "
            f"{ex:14.7g} {dev / q.epsilon:7.3f} {r.err:7.4f} "
            f"{r.decision:3d} {r.rounds_resident:6d} {r.tuples_seen:8d} "
            f"{r.seeded_tuples:6d}")
    log(f"[server] rounds {server.rounds}, tuples_scanned "
        f"{server.tuples_scanned} of {store.num_tuples}, top-up passes "
        f"{server.topup_passes}, kernel launches {launches}, wall "
        f"{wall:.3f} s")
    hist = {int(b): rungs.count(b) for b in sorted(set(rungs))}
    log(f"[server] rounds per budget rung B: {hist}")
    if failures:
        raise AssertionError(f"estimates outside 3·eps: {failures}")
    if launches != server.rounds:
        raise AssertionError(f"kernel launches {launches} != engine rounds "
                             f"{server.rounds}")
    if sum(counts.values()) != launches:
        raise AssertionError(f"the packed path launched a slab kernel: "
                             f"{counts}")
    log(f"[server] peak device memory {peak / 2**20:.1f} MiB")
    return dict(rounds=server.rounds, launches=launches, wall_s=wall,
                rungs=rungs, packed=server.engine.packed,
                sizes=np.asarray(store.chunk_sizes), results=results,
                peak=peak)


# -------------------------------------------------------------- parity ----
def small_workload(values):
    """The examples/serve_ola_workload.py workload (16,384 tuples, 8
    columns, 64 chunks)."""
    coef = tuple(1.0 / (k + 1) for k in range(8))
    exact_sum = float((values @ np.asarray(coef)).sum())
    return [
        (Query(agg="sum", expr=Linear(coef), epsilon=0.05,
               name="sum-all"), 0.0),
        (Query(agg="count", pred=Range(0, 0.0, 4e7), epsilon=0.08,
               name="count-sel"), 0.0005),
        (Query(agg="sum", expr=Linear(coef), pred=Range(0, 0.0, 6e7),
               having=Having("<", exact_sum), epsilon=0.05,
               name="having-verify"), 0.001),
        (Query(agg="avg", expr=Linear(coef), epsilon=0.05,
               name="avg-all"), 0.0015),
        (Query(agg="sum", expr=Linear(coef), epsilon=0.03,
               name="sum-tight"), 0.002),
    ]


INT_FIELDS = ("cur", "head", "offset", "scan_m", "closed")


def trace_small(device) -> tuple[list, list]:
    values = make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)
    store = store_dataset(values, num_chunks=64, fmt="ascii")
    server = OLAWorkloadServer(
        store, EngineConfig(num_workers=4, seed=7),
        options=ServerOptions(max_slots=4, synopsis_budget_tuples=4096),
        device=device)
    for q, at in small_workload(values):
        server.submit(q, arrival_t=at)
    states = []

    def on_round(srv):
        st = srv.state
        rec = {f: getattr(st, f).cpu().numpy() for f in INT_FIELDS}
        rec["stats.m"] = st.stats.m.cpu().numpy()
        states.append(rec)

    results = server.run(on_round=on_round)
    return states, results


def phase_parity() -> int:
    on_card, res_card = trace_small("cuda")
    on_cpu, res_cpu = trace_small("cpu")
    if len(on_card) != len(on_cpu):
        raise AssertionError(f"rounds differ: card {len(on_card)}, cpu "
                             f"{len(on_cpu)}")
    for r, (a, b) in enumerate(zip(on_card, on_cpu)):
        for f in a:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"round {r}: {f} differs card vs cpu")
    for a, b in zip(res_card, res_cpu):
        if (a.name, a.rounds_resident, a.tuples_seen, a.seeded_tuples,
                a.decision) != (b.name, b.rounds_resident, b.tuples_seen,
                                b.seeded_tuples, b.decision):
            raise AssertionError(f"query {a.name}: outcome differs")
        log(f"[parity] {a.name:>14} rounds {a.rounds_resident:3d} seen "
            f"{a.tuples_seen:5d} estimate card {a.estimate:.7g} cpu "
            f"{b.estimate:.7g}")
    log(f"[parity] card == cpu on integer state over {len(on_card)} rounds")
    return len(on_card)


# ------------------------------------------------------- stream parity ----
STATE_FLOATS = ("budget", "t_io", "t_cpu", "cache")
STATS_FLOATS = ("stats.ysum", "stats.ysq", "stats.psum")


def engine_trace(store, queries, device, residency: str,
                 decoded_bytes: int = 0,
                 max_rounds: int = 400) -> tuple[list, dict]:
    """A SlotOLAEngine with ``queries`` admitted mid-scan (one every other
    round), driven until every slot stops or the scan is exhausted.
    Returns each round's state (host copies) and the rounds per variant
    with the decoded cache's hits, fills and evictions."""
    cfg = EngineConfig(num_workers=4, seed=7, cache_cap=64,
                       residency=residency, decoded_cache_bytes=decoded_bytes)
    plans = ("resource_aware", "single_pass", "resource_aware", "holistic",
             "single_pass")
    eng = SlotOLAEngine(store, len(queries), cfg, device=device)
    table = empty_slot_table(len(queries), store.codec.num_cols,
                             device=device)
    state = eng.init_state()
    admit = {2 * i: (i, q) for i, q in enumerate(queries)}
    trace, modes = [], {"none": 0, "mixed": 0, "all": 0}
    try:
        for r in range(max_rounds):
            if r in admit:
                i, q = admit[r]
                table = slot_table_set(table, i, encode_slot(
                    q, store.codec.num_cols, plan=plans[i]))
            b = eng.budget_ladder(float(state.budget))
            state, data = eng.round_data(state)
            mode, data = eng.data_mode(data)
            modes[mode] += 1
            state, rep = eng.round_fn(b, mode)(state, table, data, eng.speeds)
            rec = {f: getattr(state, f).cpu().numpy()
                   for f in INT_FIELDS + STATE_FLOATS}
            for f in ("m", "ysum", "ysq", "psum"):
                rec["stats." + f] = getattr(state.stats, f).cpu().numpy()
            trace.append(rec)
            if r >= 2 * (len(queries) - 1) and (bool(rep.all_stopped)
                                                or bool(rep.exhausted)):
                break
        if eng.pipeline is not None:
            pf = eng.pipeline.counters()
            for k in ("decoded_hits", "decoded_fills", "decoded_evictions"):
                modes[k] = pf.get(k, 0)
    finally:
        eng.close()
    return trace, modes


def phase_stream_parity() -> dict:
    """examples/serve_ola_workload.py's table (16,384 tuples x 8 columns,
    64 ASCII chunks) and queries, at engine level."""
    values = make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)
    store = store_dataset(values, num_chunks=64, fmt="ascii")
    queries = [q for q, _ in small_workload(values)]
    block = store.max_chunk_tuples * store.codec.num_cols * 4
    # two decoded chunks for four workers evict every block before its
    # worker's next round (mixed rounds, evictions, no hits); four chunks
    # (one per worker) give hits as well
    runs = {
        "card packed": engine_trace(store, queries, "cuda", "packed"),
        "card stream": engine_trace(store, queries, "cuda", "stream"),
        "card stream, 2-chunk cache": engine_trace(
            store, queries, "cuda", "stream", 2 * block),
        "card stream, 4-chunk cache": engine_trace(
            store, queries, "cuda", "stream", 4 * block),
        "cpu stream": engine_trace(store, queries, "cpu", "stream"),
    }
    (base, _), *rest = runs.values()
    for name, (trace, modes) in list(runs.items())[1:]:
        if len(trace) != len(base):
            raise AssertionError(f"stream parity: {name} ran {len(trace)} "
                                 f"rounds, card packed {len(base)}")
        floats = name.startswith("card")
        for r, (a, b) in enumerate(zip(trace, base)):
            for f in a:
                if f in STATE_FLOATS or f in STATS_FLOATS:
                    if floats and not np.array_equal(a[f], b[f]):
                        raise AssertionError(f"round {r}: {f} differs, "
                                             f"{name} vs card packed")
                elif not np.array_equal(a[f], b[f]):
                    raise AssertionError(f"round {r}: {f} differs, {name} "
                                         "vs card packed")
    for name, (trace, modes) in runs.items():
        log(f"[stream-parity] {name:>28}: {len(trace)} rounds, variants "
            f"{modes}")
    two = runs["card stream, 2-chunk cache"][1]
    four = runs["card stream, 4-chunk cache"][1]
    if not (two["mixed"] and two["decoded_evictions"] and four["mixed"]
            and four["all"] and four["decoded_hits"]
            and four["decoded_evictions"]):
        raise AssertionError(f"the small decoded caches did not force mixed "
                             f"rounds, hits and evictions: {two}, {four}")
    log(f"[stream-parity] integer state identical every round ({len(runs)} "
        f"runs); float state bit for bit equal across the "
        f"{len(runs) - 1} card runs")
    return {k: dict(rounds=len(t), modes=m) for k, (t, m) in runs.items()}


# --------------------------------------------------- stream deployment ----
def write_disk_store(store, directory: str) -> ChunkStore:
    """The deployment's chunks as a disk-backed store: one file per chunk
    and a manifest with each chunk's CRC32."""
    disk = ChunkStore.create("deployment", store.codec, directory=directory)
    for j in range(store.num_chunks):
        disk.append_chunk(store.chunk_bytes(j),
                          num_tuples=int(store.chunk_sizes[j]))
    disk.finalize()
    return ChunkStore.open(directory, "deployment")


def phase_stream_deployment(store, values, packed_run: dict) -> dict:
    """The deployment's eight queries on the same arrivals, served from the
    disk-backed store with residency="stream" and a 1 GiB decoded cache
    (all 128 decoded chunks, 512 MiB, fit)."""
    queries = deployment_queries(values)
    arrivals = [at for _, at in poisson_workload(
        queries, ARRIVALS_PER_MODEL_S, seed=ARRIVAL_SEED)]
    exact = {q.name: exact_answer(values, q) for q in queries}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        disk = write_disk_store(store, tmp)
        log(f"[stream] {disk.num_chunks} chunk files "
            f"({disk.num_tuples * disk.codec.record_bytes / 2**30:.2f} GiB) "
            f"written in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        cfg = EngineConfig(residency="stream",
                           decoded_cache_bytes=DECODED_CACHE_BYTES, **ENGINE)
        server = OLAWorkloadServer(disk, cfg,
                                   options=ServerOptions(**OPTIONS),
                                   device="cuda")
        try:
            for q, at in zip(queries, arrivals):
                server.submit(q, arrival_t=at)
            eng = server.engine
            modes = {"none": 0, "mixed": 0, "all": 0}
            feed = {"s": 0.0}
            round_data, data_mode = eng.round_data, eng.data_mode

            def timed_round_data(state):
                t = time.perf_counter()
                out = round_data(state)
                feed["s"] += time.perf_counter() - t
                return out

            def counted_mode(data):
                mode, data = data_mode(data)
                modes[mode] += 1
                return mode, data

            eng.round_data, eng.data_mode = timed_round_data, counted_mode
            reset_launches()
            t0 = time.perf_counter()
            results = server.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            pf = eng.pipeline.counters()
        finally:
            server.close()
        peak = torch.cuda.max_memory_allocated()
        with OLAWorkloadServer(disk, cfg, options=ServerOptions(**OPTIONS),
                               device="cuda") as again:
            for q, at in zip(queries, arrivals):
                again.submit(q, arrival_t=at)
            profile_rounds(again, PROFILE_ROUNDS, "stream")
    if server.truncated or len(results) != len(queries):
        raise AssertionError("stream server run truncated")
    rounds = server.rounds
    log(f"[stream] {'query':>16} {'plan':>14} {'estimate':>14} "
        f"{'dev/eps':>7} {'rounds':>6} {'seen':>8} | packed: {'plan':>14} "
        f"{'rounds':>6} {'seen':>8}")
    failures, same_plans = [], True
    for r, p, q in zip(results, packed_run["results"], queries):
        ex = exact[q.name]
        dev = abs(r.estimate - ex) / abs(ex)
        if not (np.isfinite(r.estimate) and dev <= 3 * q.epsilon):
            failures.append(q.name)
        same_plans &= r.plan == p.plan
        log(f"[stream] {r.name:>16} {r.plan:>14} {r.estimate:14.7g} "
            f"{dev / q.epsilon:7.3f} {r.rounds_resident:6d} "
            f"{r.tuples_seen:8d} | packed: {p.plan:>14} "
            f"{p.rounds_resident:6d} {p.tuples_seen:8d}")
    log(f"[stream] rounds {rounds} (packed {packed_run['rounds']}); "
        f"variants {modes}; launches {launches}; decoded hits "
        f"{pf['decoded_hits']}, fills {pf['decoded_fills']}, "
        f"extract_tuples_avoided {pf['extract_tuples_avoided']}, chunk "
        f"reads {pf['chunk_reads']}, bytes read {pf['bytes_read']}")
    log(f"[stream] peak device memory {peak / 2**20:.1f} MiB "
        f"(allocated before the run {before / 2**20:.1f} MiB) vs the packed "
        f"run's {packed_run['peak'] / 2**20:.1f} MiB; peak host RSS "
        f"{peak_host_rss_bytes() / 2**30:.2f} GiB")
    log(f"[stream] mean server round {wall / rounds * 1e3:.3f} ms (packed "
        f"{packed_run['wall_s'] / packed_run['rounds'] * 1e3:.3f} ms); mean "
        f"round_data (claims + assemble + prefetch) "
        f"{feed['s'] / rounds * 1e3:.3f} ms; wall {wall:.3f} s")
    if failures:
        raise AssertionError(f"stream estimates outside 3·eps: {failures}")
    kernel_rounds = launches["slot_extract_stream"] + launches[
        "slot_eval_decoded"]
    if kernel_rounds != rounds + modes["mixed"] or sum(modes.values()) != \
            rounds:
        raise AssertionError(f"slab + decoded launches {kernel_rounds} != "
                             f"rounds {rounds} + mixed {modes['mixed']}")
    if launches["extract_parse"] != pf["decoded_fills"]:
        raise AssertionError(f"extract_parse launches "
                             f"{launches['extract_parse']} != decoded fills "
                             f"{pf['decoded_fills']}")
    if launches["slot_extract"] != 0:
        raise AssertionError("the stream path launched the packed kernel")
    if min(launches[k] for k in ("slot_extract_stream", "slot_eval_decoded",
                                 "extract_parse")) == 0:
        raise AssertionError(f"a kernel of the stream path never launched: "
                             f"{launches}")
    if peak >= STREAM_PEAK_LIMIT:
        raise AssertionError(f"stream peak device memory {peak} >= "
                             f"{STREAM_PEAK_LIMIT}")
    if same_plans:
        for r, p in zip(results, packed_run["results"]):
            if (r.rounds_resident, r.tuples_seen, r.seeded_tuples,
                    r.decision, r.estimate) != (
                    p.rounds_resident, p.tuples_seen, p.seeded_tuples,
                    p.decision, p.estimate):
                raise AssertionError(f"{r.name}: stream outcome differs from "
                                     "packed under the same plans")
        if rounds != packed_run["rounds"]:
            raise AssertionError("stream rounds differ from packed under "
                                 "the same plans")
        log("[stream] every plan as in the packed run: rounds, per-query "
            "outcomes and estimates identical")
    else:
        log("[stream] plans differ from the packed run (the decoded cache "
            "prices a cached scan cheaper): outcomes reported above")
    return dict(rounds=rounds, modes=modes, launches=launches, peak=peak,
                wall_s=wall, feed_s=feed["s"], counters=pf)


# --------------------------------------------------------------- times ----
def time_cuda(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_bound_ms(w: int, b: int, c: int, s: int, return_cols: bool):
    """Least time for one call: bytes it must move (window rows, indices,
    plan, outputs) over HBM rate vs its arithmetic over the f32 rate."""
    nbytes = (w * b * c * FIELD_BYTES + w * b * 4 + 2 * w * 4
              + 3 * s * c * 4 + 3 * s * 4 + w * s * 4 * 4
              + (w * b * c * 4 if return_cols else 0))
    # per row: 14 digit multiply-adds (2 ops) + 3 ops per field; per slot:
    # 2C compares, C multiply-adds, 8 ops of masking and sums
    ops_ = w * b * (c * (14 * 2 + 3) + s * (2 * c + 2 * c + 8))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, iters: int, match: tuple):
    """Mean device ms per call of the kernels whose name contains one of
    ``match``, from a ``torch.profiler`` (CUPTI) trace of ``iters`` calls;
    None when the trace holds no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if any(m in e.key for m in match))
    return us / 1e3 / iters if us > 0 else None


def phase_times(packed: torch.Tensor, sizes: np.ndarray, rungs: list,
                wall_s: float) -> dict:
    rng = np.random.default_rng(5)
    c = packed.shape[2] // FIELD_BYTES
    per_rung, per_call, sets = {}, {}, {}
    for b in sorted(set(rungs) | {4096}):
        # 16 input sets over distinct chunks, cycled, so a launch does not
        # find its window rows in L2 from the launch before
        sets[b] = []
        for _ in range(16):
            inp = list(kernel_inputs(packed, sizes, b, rng))
            inp[3] = torch.full_like(inp[3], b)      # full budgets
            sets[b].append(inp)

        def call(i, b=b):
            return slot_extract_cuda(*sets[b][i % 16], return_cols=True)

        # device time of the two kernels, and the wall per call with the
        # wrapper's host work (checks, allocation, ctypes) included
        per_rung[b] = device_ms(call, 200, ("slot_extract_blocks",
                                            "reduce_partials"))
        per_call[b] = time_cuda(call, 200)

    def plain(i):
        (p, jw, idx, be, co, lo, hi, isc, gate, wts) = sets[4096][i % 16]
        return slot_extract_ref(p, jw, idx, be, co, lo, hi, isc, gate,
                                num_cols=c, return_cols=True, weights=wts)

    plain_ms = time_cuda(plain, 20)
    bound_ms, bound_by = kernel_bound_ms(4, 4096, c, 8, True)
    timed = per_rung if all(v is not None for v in per_rung.values()) \
        else per_call
    kernel_s = sum(timed[b] for b in rungs) / 1e3
    return dict(ms=timed[4096], call_ms=per_call, device_ms=per_rung,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                round_ms=wall_s / len(rungs) * 1e3,
                kernel_share=kernel_s / wall_s,
                share_source="device" if timed is per_rung else "call")


def bound(nbytes: float, ops_: float) -> tuple[float, str]:
    """Least ms for work that moves ``nbytes`` and does ``ops_`` operations:
    the larger of the two over the H100's HBM and float32 rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slab_bound_ms(w: int, b: int, c: int, s: int, cap: int, decoded: bool):
    """The slab kernels' bound: window rows (256-byte records, or C floats
    decoded), indices, budgets, scan positions and plan read once, stats
    and the (W, cap, C) cache rows written once; per row the parse (raw
    only) and per slot 2C compares, C multiply-adds and 8 ops."""
    row = c * 4 if decoded else c * FIELD_BYTES
    nbytes = (w * b * row + w * b * 4 + 2 * w * 4 + 3 * s * c * 4
              + 3 * s * 4 + w * s * 4 * 4 + w * cap * c * 4)
    ops_ = w * b * ((0 if decoded else c * (14 * 2 + 3))
                    + s * (2 * c + 2 * c + 8))
    return bound(nbytes, ops_)


def phase_stream_times(packed: torch.Tensor, sizes: np.ndarray) -> dict:
    """Device and per-call times of the three slab-path kernels at the main
    path's shapes, their bounds and their plain versions' times."""
    rng = np.random.default_rng(17)
    n, m_max, rec = packed.shape
    c = rec // FIELD_BYTES
    out = {}
    for b in (8, 4096):
        sets = []
        for _ in range(16):
            inp = list(kernel_inputs(packed, sizes, b, rng))
            inp[3] = torch.full_like(inp[3], b)          # full budgets
            slab, idx, b_eff, plan, mb = stream_inputs(inp)
            w, r, _ = slab.shape
            dec = extract_parse_cuda(slab.reshape(w * r, rec), c).reshape(
                w, r, c)
            sets.append((slab, dec, (idx, b_eff, *plan, mb)))

        def raw(i, b=b, sets=sets):
            slab, _, args = sets[i % 16]
            return slot_extract_stream_cuda(slab, *args, cache_cap=CACHE_CAP)

        def decoded(i, b=b, sets=sets):
            _, dec, args = sets[i % 16]
            return slot_eval_decoded_cuda(dec, *args, cache_cap=CACHE_CAP)

        match = ("stream_blocks", "reduce_partials")
        out[("slot_extract_stream", b)] = dict(
            device_ms=device_ms(raw, 200, match), call_ms=time_cuda(raw, 200))
        out[("slot_eval_decoded", b)] = dict(
            device_ms=device_ms(decoded, 200, match),
            call_ms=time_cuda(decoded, 200))
        if b == 4096:
            def plain_raw(i):
                slab, _, (idx, be, co, lo, hi, isc, gate, wts, mb) = \
                    sets[i % 16]
                kref.slot_extract_stream_ref(slab, idx, be, co, lo, hi, isc,
                                             gate, num_cols=c, weights=wts)
                return kref.stream_cache_rows_ref(slab, idx, be, mb,
                                                  CACHE_CAP, c)

            def plain_dec(i):
                _, dec, (idx, be, co, lo, hi, isc, gate, wts, mb) = \
                    sets[i % 16]
                kref.slot_eval_decoded_ref(dec, idx, be, co, lo, hi, isc,
                                           gate, weights=wts)
                return kref.window_cache_rows_ref(
                    kref.gather_window(dec, idx), be, mb, CACHE_CAP)

            out[("slot_extract_stream", b)]["plain_ms"] = time_cuda(
                plain_raw, 20)
            out[("slot_eval_decoded", b)]["plain_ms"] = time_cuda(
                plain_dec, 20)
        for name, dflag in (("slot_extract_stream", False),
                            ("slot_eval_decoded", True)):
            out[(name, b)]["bound"] = slab_bound_ms(4, b, c, 8, CACHE_CAP,
                                                    dflag)
        del sets
    chunks = [packed[j, : int(sizes[j])].contiguous()
              for j in rng.choice(n, size=16, replace=False)]

    def parse(i):
        return extract_parse_cuda(chunks[i % 16], c)

    t = int(sizes[0])
    out[("extract_parse", t)] = dict(
        device_ms=device_ms(parse, 100, ("parse_rows",)),
        call_ms=time_cuda(parse, 100),
        plain_ms=time_cuda(lambda i: kref.parse_ascii_ref(chunks[i % 16], c),
                           10),
        bound=bound(t * rec + t * c * 4, t * c * (14 * 2 + 3)))
    return out


def profile_rounds(server, rounds: int, tag: str) -> None:
    """Where a server round's time goes: ``rounds`` rounds of ``server``
    under ``torch.profiler`` — device busy share of the wall, the kernels by
    device time, the host ops by self CPU time, and the share of the wall
    spent feeding the round its data (``round_data``: claim prediction,
    slab assembly and copy, read-ahead hints)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    feed = server.engine.round_data

    def traced_round_data(state):
        with record_function("round_data"):
            return feed(state)

    server.engine.round_data = traced_round_data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.run(max_rounds=rounds)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # the round_data annotation also appears as a device-side range: it is
    # a span, not device work, so it is left out of the busy time
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.key != "round_data"]
    busy = sum(e.self_device_time_total for e in on_device)
    feed_us = sum(e.cpu_time_total for e in events if e.key == "round_data"
                  and e.device_type == torch.autograd.DeviceType.CPU)
    log(f"[profile {tag}] {server.rounds} rounds under the profiler: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}%), idle "
        f"{100 - 100 * busy / wall_us:.1f}%; round_data "
        f"{feed_us / 1e3:.1f} ms ({100 * feed_us / wall_us:.1f}% of the "
        f"wall)")
    dev = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
    for e in dev:
        log(f"[profile {tag}] device {e.self_device_time_total / 1e3:9.2f} "
            f"ms x{e.count:6d}  {e.key[:70]}")
    host = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        log(f"[profile {tag}] host   {e.self_cpu_time_total / 1e3:9.2f} ms "
            f"x{e.count:6d}  {e.key[:70]}")


def phase_profile(store, values, rounds: int = 200) -> None:
    """The packed deployment's first ``rounds`` rounds under the
    profiler (see :func:`profile_rounds`)."""
    queries = deployment_queries(values)
    arrivals = [at for _, at in poisson_workload(
        queries, ARRIVALS_PER_MODEL_S, seed=ARRIVAL_SEED)]
    with run_server(store, queries, arrivals, "cuda") as server:
        profile_rounds(server, rounds, "packed")


# ---------------------------------------------------------------- main ----
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke runs on the GPU only", file=sys.stderr)
        return 2
    # the plain versions run on the card too: keep float32 products in
    # full float32 (no TF32 matmul or convolution path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    log(f"[device] {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    phase_build()

    t0 = time.perf_counter()
    values, store = build_store(NUM_TUPLES, NUM_CHUNKS, NUM_COLS)
    log(f"[data] {store.num_tuples} tuples x {NUM_COLS} columns, "
        f"{store.num_chunks} chunks, {store.codec.record_bytes}-byte ASCII "
        f"records ({store.num_tuples * store.codec.record_bytes / 2**30:.2f}"
        f" GiB) generated and encoded in {time.perf_counter() - t0:.1f} s")

    packed, sizes = store.packed_device_view("cuda")
    checks = phase_kernel(packed, sizes)
    stream_checks = phase_stream_kernels(packed, sizes)
    del packed
    srv = phase_server(store, values)
    srv_rungs, launches = srv["rungs"], srv["launches"]
    phase_parity()
    phase_stream_parity()
    times = phase_times(srv["packed"], srv["sizes"], srv["rungs"],
                        srv["wall_s"])
    stimes = phase_stream_times(srv["packed"], srv["sizes"])
    packed_run = {k: srv[k] for k in ("results", "rounds", "peak", "wall_s")}
    del srv
    torch.cuda.empty_cache()
    dep = phase_stream_deployment(store, values, packed_run)
    phase_profile(store, values, PROFILE_ROUNDS)
    del values

    def us(t):
        return "not measured" if t is None else f"{t * 1e3:.2f}"

    log(f"[times] {card}: slot_extract at W=4 B=4096 C=16 S=8 with cols: "
        f"{us(times['device_ms'][4096])} us device time per launch (both "
        f"kernels, profiler); {us(times['call_ms'][4096])} us per call with "
        f"the wrapper's host work (CUDA events); bound "
        f"{times['bound_ms'] * 1e3:.3f} us ({times['bound_by']}); plain "
        f"version {times['plain_ms'] * 1e3:.1f} us")
    log(f"[times] {card}: device us per launch by rung: "
        + ", ".join(f"B={b}: {us(t)}" for b, t in times["device_ms"].items()))
    log(f"[times] {card}: us per call by rung: "
        + ", ".join(f"B={b}: {us(t)}" for b, t in times["call_ms"].items()))
    log(f"[times] {card}: server mean round {times['round_ms']:.3f} ms over "
        f"{len(srv_rungs)} rounds; kernel share of round time "
        f"{100 * times['kernel_share']:.3f}% ({times['share_source']} time "
        f"per rung x rounds at each rung / server wall)")
    for (name, b), v in stimes.items():
        shape = (f"T={b} rows" if name == "extract_parse"
                 else f"W=4 B={b} C=16 S=8 cap={CACHE_CAP}")
        plain = v.get("plain_ms")
        log(f"[times] {card}: {name} at {shape}: {us(v['device_ms'])} us "
            f"device time per launch (profiler); {us(v['call_ms'])} us per "
            f"call with the wrapper (CUDA events); bound "
            f"{v['bound'][0] * 1e3:.3f} us ({v['bound'][1]}); plain version "
            f"{'not measured' if plain is None else us(plain)} us; "
            f"{dep['launches'][name] / dep['rounds']:.4f} launches per "
            f"stream-deployment round")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    def timed(name, b):
        v = stimes[(name, b)]
        ms = v["device_ms"] if v["device_ms"] is not None else v["call_ms"]
        return dict(ms=ms, plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                    bound_by=v["bound"][1], library_ms=None)

    t_rows = int(store.chunk_sizes[0])
    kernels = [{
        "name": "slot_extract", "route": "cuda",
        "source": "src/repro_torch/csrc/slot_extract.cu",
        "replaces": "src/repro/kernels/slot_extract.py:101",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err_cols"] for r in checks
                           if r["max_abs_err_cols"] is not None),
        "max_rel_err_sums": max(r["max_rel_err_sums"] for r in checks),
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None,
    }, {
        "name": "slot_extract_stream", "route": "cuda",
        "source": "src/repro_torch/csrc/slot_extract_stream.cu",
        "replaces": "src/repro/kernels/slot_extract.py:484",
        "launches": dep["launches"]["slot_extract_stream"],
        "max_abs_err": max(r["max_abs_err"] for r in stream_checks["stream"]),
        "max_rel_err_sums": max(r["max_rel_err_sums"]
                                for r in stream_checks["stream"]),
        **timed("slot_extract_stream", 4096),
    }, {
        "name": "slot_eval_decoded", "route": "cuda",
        "source": "src/repro_torch/csrc/slot_extract_stream.cu",
        "replaces": "src/repro/kernels/slot_extract.py:514",
        "launches": dep["launches"]["slot_eval_decoded"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in stream_checks["decoded"]),
        "max_rel_err_sums": max(r["max_rel_err_sums"]
                                for r in stream_checks["decoded"]),
        **timed("slot_eval_decoded", 4096),
    }, {
        "name": "extract_parse", "route": "cuda",
        "source": "src/repro_torch/csrc/extract_parse.cu",
        "replaces": "src/repro/kernels/extract_parse.py:55",
        "launches": dep["launches"]["extract_parse"],
        "max_abs_err": max(r["max_abs_err"] for r in stream_checks["parse"]),
        **timed("extract_parse", t_rows),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
