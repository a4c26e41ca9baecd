#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --kernels    # build, kernel checks and times only
    python3 chip_smoke.py --ml         # build and the ML plane's phases only
    python3 chip_smoke.py --train      # build and the training phase only
    python3 chip_smoke.py --families   # build and the other families only
    python3 chip_smoke.py --shard      # build, the sharded verify cell and
                                       # the sharded train step only
    python3 chip_smoke.py --dryrun     # build, the sharded train step, a
                                       # train step's time and the dry run

Needs a CUDA device and ``nvcc``; exits non-zero, printing no result, when
either is missing or any phase fails.  Phases:

1. build     — compile every ``src/repro_torch/csrc/*.cu`` with nvcc for
               sm_90a (one process per source, all started together).
2. kernel    — each kernel against its plain PyTorch version on the card at
               the main path's shapes (W=4 workers, C=16 columns, S=8 slots,
               cache cap 128) with the tolerance stated below, at every
               window width of EDGE_B (a partial warp, one warp, more than
               one, one tile, two tiles, the engine's budget_max and
               beyond it), and three equalities bit for bit: the slab kernel
               on chunks ``jw`` == the packed kernel on those ``jw``; the
               decoded kernel fed by ``extract_parse`` == the slab kernel on
               the raw rows; a mixed pair with complementary budgets == the
               single kernel; the slab kernels' cache rows off the window
               +0.0 when torch.empty hands out NaN-filled memory.  The
               grouped kernel at the grouped deployment's
               shapes (W=4, S=4, G=9, C=4) and the main store's (C=16, S=8
               with grouped, ungrouped and discovery-only slots), B in
               EDGE_B: against its plain version, tallies bit for bit, and
               every tracked cell bit for bit equal to kernel 1 on its
               group_fanout slot.  ``chunk_agg`` over the whole store with
               the deployment's plans (totals against float64 answers) and
               ``round_stats`` at (4, 4096, 256), each through its ``ops``
               entry point.  Every kernel launched three times on the same
               inputs must give the same bits each time.
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
               decoded cache for its first CUT_ROUNDS rounds: every answer
               retired by then within 3·ε and, under phase 3's plans, it
               and the state at the cut bit for bit phase 3's, slab-kernel +
               decoded-kernel launches == rounds + mixed rounds,
               extract_parse launches == decoded fills, peak device memory
               below 512 MiB (printed beside the packed run's).
7. grouped parity — benchmarks/bench_workload.py's grouped smoke lane
               (8,192 wiki-like tuples, 12 chunks, 16 languages, 4 grouped
               queries) on the card and on the CPU: integer state, the
               cells' gm and the promotions identical round for round.
8. grouped deployment — the main path of the GROUP BY slice
               (GROUP_QUERIES queries over GROUP_DEPLOY_TUPLES tuples):
               every query retires, mean top-5 recall >= 0.9, each query's
               five largest tracked cells within 3·ε of their exact totals
               and a non-empty __other__ cell, the grouped kernel launched
               once per round and no other kernel.
9. ptf       — the paper's verification chain (EstimationController
               .run_verification) on explore_ptf.py's batch (32,768 PTF-like
               tuples, 64 binary chunks, the ``ref`` extraction path), card
               against CPU: same verdicts, stop, rounds and tuples; then the
               same three HAVING checks over 8,388,608 PTF-like tuples as
               fixed-width ASCII in 128 chunks on the card, through kernel 1
               (launches == rounds).  Each verdict equals the float64
               truth's and the chain stops where the truth says.
10. sched parity — the SLO scheduler on the small example table with SLOs
               (max_slots=2, slot_capacity=1.0, preemption), card against
               CPU: integer state equal every round under the committed
               claim order; under the variance order equal up to the first
               round whose claim orders differ, where the swapped chunks'
               keys must agree within a float32 relative 1e-5 (a near tie).
               On the card, bit for bit: NEUTRAL == unscheduled and
               scheduled stream == scheduled packed.
11. sched     — the scheduled deployment: the packed deployment's store
               (the copy already on the card) and queries with
               bench_workload.py's sched lane (its SLO mix, Poisson
               arrivals at 2,000 per modeled second), max_slots=4,
               SchedulerConfig(slot_capacity=2.0, preempt=True), variance
               claims.  Every query completes; one that retired on its own
               within 3·ε of exact, a shed or deadline-stopped one within 3x
               its own error ratio; kernel 1 launches == rounds; a round ran
               with a fairness weight below 1, and kernel 1 on that round's
               inputs matches its plain version in one device kernel.
12. rollup    — bench_workload.py's hot/cold mix (56 queries) on the same
               store with max_slots=8 and RollupConfig(promote_hits=2): a
               tier-1 answer, every answer within 3·ε, launches == rounds.
13. spmd parity — the multi-device engines (SPMDEngine, SlotSPMDEngine,
               ServerOptions(mesh=...)) with 8 workers over 1 (NCCL), 2 and
               4 (gloo) ranks spawned on the one card: tests/
               test_engine_spmd.py's drives (frozen, slot with a mid-scan
               admission, streamed, streamed with a two-chunk decoded
               cache, grouped, the server) and, over 2 ranks, [sched-
               parity]'s scheduled workload under NEUTRAL and variance
               claims: every rank's state after every round and the
               server's results bit for bit the single-device card run's;
               kernels 1-5 launched on every rank.  (Phase 2 also holds
               kernels 1-4 at a rank's worker widths W = 1 and 2 against
               their plain versions and their own rows of the W = 4
               launch, bit for bit: [rank-width].)
14. spmd      — the packed deployment served over 2 gloo ranks x 2
               workers on the one card, each rank with its own copy of
               the store, cut after CUT_ROUNDS of phase 3's rounds: the
               state at the cut and every answer retired by then bit for
               bit phase 3's at that round, kernel 1 launches == rounds on
               each rank; per rank the ms
               per round, the ms per round in collectives, the device idle
               share of the first 25 rounds and the peak device memory.
15. times     — each kernel's time per launch beside its bound and the plain
               version's time, the device kernels each call runs (one for
               every kernel but extract_parse), the mean server
               rounds, the kernel's share of round time and the tally
               fold's, each beside the card's name and power limit.

16. models    — the ML plane: ``DecoderLM`` at qwen3-0.6b's published
               widths (28 layers, d_model 1024, 16 Q / 8 KV heads of 128,
               SwiGLU 3072, vocab 151,936 padded to 152,064, tied, bf16
               compute), random weights from a seed on the card: decode
               token by token == forward within DECODE_TOL of the largest
               logit; at PARITY_LAYERS layers (full widths) and float32
               compute, TF32 off, the card's logits == the CPU's on the same
               weights within F32_TOL; prefill ms of a (4, 512) batch and
               decode ms a step at B = 3 (medians), peak device memory.
17. serve     — ``ServeEngine`` at 28 layers with serve_batched.py's
               shape (6 requests of 8-token prompts, 3 slots, 12 new
               tokens) at max_len 512: every request done with 12 tokens,
               a second engine of the same seed gives the same tokens; at
               PARITY_LAYERS layers, float32, the card's tokens == the CPU
               engine's; steps, ms a step, tokens a second, peak memory.
18. ola-eval  — ``ola_eval`` over the 28-layer model's per-example loss
               on ola_eval_demo.py's shards (ε 0.02, batch 32, seed 1):
               within 3·ε of the exhaustive mean computed on the card, on
               fewer examples than the set holds.
19. ingest    — ``IngestGate(standard_ingest_queries(0.05))`` over
               ``SyntheticCorpus(vocab=151936, num_segments=8,
               docs_per_segment=512, doc_len=256, poison_every=3)``'s
               metadata stores, card against CPU: the same decisions,
               failed queries and tuples ratios; poisoned segments
               rejected, clean ones admitted; kernel 1 launched.
20. train     — the training plane: smollm-135m reduced at float32
               compute, the same torch-initialised tree on the card and
               the CPU, four train steps: losses and the first grad_norm
               within TRAIN_TOL; then ``Trainer`` at smollm-135m's published
               widths (30 layers, d_model 576, 9/3 heads of 64, d_ff 1,536,
               vocab 49,152, tied, bf16 compute, remat) over
               train_with_verification.py's corpus (8 segments of 128
               documents, every third poisoned) at batch 4 x 128 for 30
               steps, a checkpoint every 15 and a failure at step 16:
               every gate decision the CPU gate's, kernel 1 launched, one
               restart restoring the checkpoint bit for bit, losses finite
               and falling; ms a step, tokens a second, aten ops a step,
               busy share, peak memory (the state's share and what a
               step adds), checkpoint save / restore seconds.
21. families  — the five other model families at their published widths,
               bf16, random weights, one at a time: mixtral-8x7b and
               phi3.5-moe at 4 of their 32 layers (depth the only cut),
               qwen2-vl-2b (256 patches on a 16 x 16 grid + 256 text
               tokens), whisper-large-v3 (1,500 encoder frames),
               zamba2-1.2b, xlstm-125m (prefill 1,024: the chunkwise
               mLSTM): prefill ms, decode ms a step at B = 3, aten ops a
               step, peak memory, the MoE pair's dropped-token share;
               decode token by token == forward at float32 within the
               reference oracle's 2e-3 (the MoE pair at 2 layers, capacity
               factor 8; zamba2 at 12 of 38, all 38 read ungated), and
               card == CPU within F32_TOL on the same weights at
               FAM_PARITY_LAYERS, the MoE dispatch's integer state equal
               (near ties counted); then
               ``ServeEngine`` serves zamba2-1.2b in serve_batched.py's
               shape at max_len 512: tokens a second.
22. families-train — one reduced float32 train step of each token
               family (mixtral, zamba2, xlstm) card == CPU within
               TRAIN_TOL; ``Trainer`` at xlstm-125m's published widths
               (bf16, remat) over train_with_verification.py's corpus at
               4 x 128, one step a clean segment (6): gate decisions the
               CPU gate's, kernel 1 launched (beside the gate's rounds),
               losses finite; ms a step, tokens a second, aten ops a
               step, peak memory.
23. examples  — the seven ``repro_torch.examples`` mains in-process on the
               card at their defaults (train_with_verification at
               ``--steps 12``); quickstart's and serve_ola_workload's
               answers within 3·ε of exact; train_with_verification's gate
               decisions the CPU gate's and its losses finite.

24. verify-cell — ``launch/verify_cell.py``'s production program at its
               widths (6 ASCII columns, 96-byte records, 65,536-tuple
               chunks, the three HAVING queries at eps 0.05, budget 256,
               one worker a rank) with the chunk count cut from 4,096 to
               256 (1,536 MiB raw) over 2 gloo ranks on the one card: the
               sharded layout (each rank its 128 chunks and its own
               committed order) to every query's stop, equal on every
               rank and, over the first 8 rounds, to the same ranks on
               the CPU (integers equal, floats within float32 1e-5); the
               replicated layout (kernel 1, once a round) bit for bit the
               single-device engine; verdicts the float64 truth's,
               estimates within 3 eps; ms and collective ms a round (50
               rounds) and each rank's peak memory for both layouts.
25. shard     — smollm-135m's train_4k cell (``launch/steps.py``
               ``build_cell``) at its published widths (bf16, remat), the
               batch cut to 4 x 128, on a (data 2, model 2) mesh of 4
               gloo ranks on the one card (DTensor parameters, Adam
               moments and batch): the float32 step at 4 layers equal to
               the single-device step on the card within 1e-5 relative
               (loss, grad_norm, each updated parameter in norm, each
               leaf of Adam's first moment, the step's gradient); on a
               traced step every block's output reaches
               ``constrain("btd")`` batch-sharded over data; 2 steps,
               losses finite and equal on
               every rank; qwen3-0.6b's decode cell at 4 layers, float32,
               equal to single-device decode within 1e-5 of the largest
               logit; ms a step, the first step's collectives, each
               rank's resident state and peak memory.
26. dryrun    — ``launch/dryrun.py`` in a spawned process (its fake
               process group is process-global; no card, no memory: meta
               DTensors) prints three records: smollm-135m's train_4k cell
               at full width on the 16 x 16 production mesh of a fake
               256-rank group; [shard]'s own cell on a fake (data 2, model
               2) group, whose state bytes a rank, read from the layouts,
               must equal [shard]'s measured resident bytes on every rank
               to the byte, and whose collectives by kind must equal
               [shard]'s first step's; [train]'s step on one rank, whose
               roofline bound (priced with ``roofline/hw.py``'s H100
               constants) must not exceed [train]'s measured median step.

``--kernels`` runs phases 1, 2 and the kernel times of 15 on the same
stores and exits 0 when they pass, printing no result lines.  ``--spmd``
runs phases 1, 2's rank-width checks, 3, 13 and 14 and exits 0 when they
pass, printing no result lines.  ``--ml`` runs phases 1 and 16-23 and
exits 0 when they pass, printing no result lines; ``--train`` runs phases
1 and 20 the same way, ``--families`` phases 1, 21 and 22, ``--shard``
phases 1, 24 and 25, ``--dryrun`` phases 1, 25, a median of
TRAIN_TIME_REPS steps of [train]'s step at full width (no ``Trainer``)
and 26.

The line before the last is one JSON object describing every kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.controller import EstimationController  # noqa: E402
from repro_torch.core.engine import EngineConfig, SlotOLAEngine  # noqa: E402
from repro_torch.core.queries import (  # noqa: E402
    TRUE, And, Column, GroupBy, Having, Linear, Query, Range,
    empty_slot_table, encode_slot, linear_plan, slot_table_set)
from repro_torch.data.chunkstore import ChunkStore  # noqa: E402
from repro_torch.data.corpus import (  # noqa: E402
    SyntheticCorpus, standard_ingest_queries)
from repro_torch.data.generator import (  # noqa: E402
    make_ptf_like, make_synthetic_zipf, make_wiki_like, store_dataset)
from repro_torch.data.pipeline import peak_host_rss_bytes  # noqa: E402
from repro_torch.distributed import FailureInjector  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    explore_ptf, ola_eval_demo, quickstart, serve_batched,
    serve_ola_workload, trace_workload, train_with_verification)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.chunk_agg import (  # noqa: E402
    chunk_agg_cuda, launch_split)
from repro_torch.kernels.extract_parse import extract_parse_cuda  # noqa: E402
from repro_torch.kernels.ref import slot_extract_ref  # noqa: E402
from repro_torch.kernels.round_stats import round_stats_cuda  # noqa: E402
from repro_torch.kernels.slot_extract import slot_extract_cuda  # noqa: E402
from repro_torch.kernels.slot_extract_grouped import (  # noqa: E402
    slot_extract_grouped_cuda)
from repro_torch.kernels.slot_extract_stream import (  # noqa: E402
    slot_eval_decoded_cuda, slot_extract_stream_cuda)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.convert import tree_from_module  # noqa: E402
from repro_torch.models.vlm import build_positions3  # noqa: E402
from repro_torch.roofline.hw import H100_SXM  # noqa: E402
from repro_torch.ola_ml import IngestGate, ola_eval  # noqa: E402
from repro_torch.sampling.permutation import (  # noqa: E402
    chunk_seed, permutation_window_dyn)
from repro_torch.sched import (  # noqa: E402
    NEUTRAL, QuerySLO, SchedulerConfig, WorkloadScheduler,
    scan_tuples_per_s, slot_chunk_variances)
from repro_torch.serve.ola_server import (  # noqa: E402
    OLAWorkloadServer, ServerOptions, poisson_workload)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.rollup import RollupConfig  # noqa: E402
from repro_torch.train import checkpoint as train_ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_train_state, make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, tree_map  # noqa: E402

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
# [stream] and [spmd] serve the deployment's first CUT_ROUNDS rounds (of
# 5,137, all but four at B = 8; 4,982 of them are count-sel-tight's alone):
# the answers retired by then and the state at the cut, which holds the
# other queries' statistics, are compared with phase 3's at that round.
# [spmd] ran 1,500 rounds until a 1,128 s proof on a slow host; [stream] ran
# all 5,137 (123 s on the H100) until a proof overran the 1,200 s limit
CUT_ROUNDS = 500
# rounds of each deployment profiled: the profiler's own processing of a
# round's ~900-1,900 launch events costs far more than the round, so few
PROFILE_ROUNDS = 25

# the grouped kernels' table: benchmarks/bench_workload.py's grouped lane
# data (40 languages) as wiki-like 64-byte ASCII records in 128 uneven
# chunks, GROUP_TUPLES of them (cut from 8,388,608, PERF.md §4)
GROUP_TUPLES = 262_144
GROUP_CHUNKS = 128
GROUP_LANGS = 40
# the grouped deployment: the first GROUP_QUERIES of that lane's eight
# grouped queries (4 slots) over GROUP_DEPLOY_TUPLES tuples of the same
# generator.  Every round of this workload runs at B = 8 and its queries
# read most of the table, so the round count grows with it
# (scripts/rehearse_grouped.py on the CPU: 8,368 rounds with all eight
# queries at 262,144 tuples, 33,768 at 1,048,576; this phase: 1,998 with
# four at 65,536).  All eight at 262,144 took 281 s on an H100 80GB HBM3
# at 700 W, and the smoke then overran its 1,200 s limit.  With all
# eight, the four admitted late miss 3·ε below 262,144 tuples, in the
# reference too (ROADMAP queue 3), so the cut keeps the four admitted at
# once.
GROUP_DEPLOY_TUPLES = 65_536
GROUP_QUERIES = 4
GROUP_ENGINE = dict(num_workers=4, seed=7, max_groups=8)
GROUP_OPTIONS = dict(max_slots=4, synopsis_budget_tuples=0)
GROUP_TOP_K = 5
# the grouped smoke lane (parity phase): 8,192 tuples, 12 chunks, 16
# languages, the first four of the same queries
LANE = dict(tuples=8192, chunks=12, langs=16, queries=4)

# the verification chain: examples/explore_ptf.py's batch (32,768 PTF-like
# tuples, seed 1, 64 binary chunks, a 4,096-tuple synopsis), and the same
# checks over a fixed-width ASCII PTF-like table of the deployment's size
PTF = dict(tuples=32768, chunks=64, seed=1)
PTF_ENGINE = dict(num_workers=4, strategy="resource_aware", seed=3)
PTF_SYNOPSIS = 4096
PTF_ASCII = dict(tuples=8_388_608, chunks=128)
# the scheduled deployment: bench_workload.py's sched lane on the packed
# deployment's table and queries: its SLO mix (seed 12), its Poisson
# arrivals at 2,000 per modeled second (seed 11) and its capacity rule
# max(2, slots / 2).  At the packed cell's 20 arrivals per modeled second
# no more than two queries were ever resident at once (8,388,608 tuples on
# an H100 80GB HBM3 at 700 W), so a capacity of 2.0 never divided a
# round's budget.
SLO_SEED = 12
SCHED_RATE = 2000.0
SCHED_OPTIONS = dict(max_slots=4, synopsis_budget_tuples=4096)
SCHED_CAPACITY = 2.0
# the hot/cold mix: bench_workload.py's rollup lane (4 hot patterns x 10
# repeats, 16 cold queries, seed 21; Poisson arrivals at 2,000 per modeled
# second, seed 22)
ROLLUP_MIX = dict(n_hot=4, repeats=10, n_cold=16, seed=21)
ROLLUP_RATE = 2000.0
ROLLUP_ARRIVAL_SEED = 22
ROLLUP_OPTIONS = dict(max_slots=8, synopsis_budget_tuples=4096)

# window widths of the kernel checks: a partial warp, one warp, a warp and
# a bit, two warps, one tile of 256 positions, two tiles, the engine's
# budget_max (4096, core/engine.py) and twice it
EDGE_B = (1, 8, 31, 33, 64, 256, 257, 4096, 8192)
# the kernels that run one device kernel per call
ONE_LAUNCH = ("slot_extract", "slot_extract_grouped", "slot_extract_stream",
              "slot_eval_decoded", "chunk_agg", "round_stats")

EXAMPLES = {m.__name__.rsplit(".", 1)[-1]: m for m in (
    quickstart, serve_ola_workload, trace_workload, explore_ptf,
    ola_eval_demo, serve_batched, train_with_verification)}

KERNELS = (slot_extract_cuda, slot_extract_stream_cuda,
           slot_eval_decoded_cuda, extract_parse_cuda,
           slot_extract_grouped_cuda, chunk_agg_cuda, round_stats_cuda)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__.removesuffix("_cuda"): k.launches for k in KERNELS}

# H100 SXM published peaks (roofline/hw.py): HBM rate and the float32
# rate outside the tensor cores, which the kernel's integer and float
# arithmetic runs on
HBM_BYTES_PER_S = H100_SXM.hbm_bw
F32_OPS_PER_S = H100_SXM.peak_flops_f32
FIELD_BYTES = 16


START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the seconds since the script started."""
    print(f"{time.perf_counter() - START:7.1f}s {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def same_bits(fn, what: str, first=None):
    """``fn()`` three times on the same inputs (twice after ``first``, a
    result of it already in hand): every tensor it returns must have the
    same bits each time (a race, or a tile counter left set, would show).
    Returns the first result."""
    runs = [fn() if first is None else first] + [fn() for _ in range(2)]
    torch.cuda.synchronize()

    def flat(out):
        out = out if isinstance(out, tuple) else (out,)
        return [t for t in out if t is not None]

    first = flat(runs[0])
    for again in runs[1:]:
        for a, b in zip(first, flat(again), strict=True):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"{what}: a repeated launch on the same "
                                     "inputs gave other bits")
    return runs[0]


@contextlib.contextmanager
def dirty_empty():
    """Meanwhile ``torch.empty`` hands out NaN-filled float tensors, as a
    reused block of the caching allocator may hold: an output element that a
    kernel leaves unwritten shows as NaN."""
    empty = torch.empty

    def dirty(*shape, **kw):
        t = empty(*shape, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    torch.empty = dirty
    try:
        yield
    finally:
        torch.empty = empty


def off_window(b: int, b_eff: torch.Tensor, m_before: torch.Tensor,
               cap: int) -> np.ndarray:
    """(W, cap) True where a cache row holds no window position: row r holds
    position r - m_before[w] when that is in [0, min(B, b_eff[w]))."""
    k = np.arange(cap)[None, :] - m_before.cpu().numpy()[:, None]
    return (k < 0) | (k >= np.minimum(b_eff.cpu().numpy(), b)[:, None])


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
    return deployment_query_list(c, 1.07 * float(lin[having_sel].sum()))


def deployment_query_list(c: int, thr: float) -> list[Query]:
    """:func:`deployment_queries` over ``c`` columns with the HAVING
    threshold ``thr`` (queries hold lambdas and do not pickle: a spawned
    rank rebuilds them from these two numbers)."""
    coef = tuple(1.0 / (k + 1) for k in range(c))
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


def build_wiki_store(num_tuples: int, num_chunks: int, langs: int):
    """(values (T, 4) float64, ASCII ChunkStore in uneven chunks): the
    grouped lane's wiki-like table, seed 0."""
    values, _ = make_wiki_like(num_tuples, num_languages=langs, seed=DATA_SEED)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        store = store_dataset(values, num_chunks=num_chunks, fmt="ascii",
                              uneven=True, seed=DATA_SEED,
                              encode_map=pool.map)
    return values, store


def grouped_queries(nq: int = GROUP_QUERIES) -> list[Query]:
    """bench_workload.py's grouped lane (rng seed 3): SUM over hits or
    bytes, ε from U(0.05, 0.10), GroupBy(col=0, max_groups=8, top_k=5)."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(nq):
        col = int(rng.choice([1, 2]))
        eps = float(rng.uniform(0.05, 0.10))
        coeffs = tuple(1.0 if k == col else 0.0 for k in range(4))
        out.append(Query(agg="sum", expr=Linear(coeffs), epsilon=eps,
                         name=f"g{i}-c{col}", group_by=GroupBy(
                             col=0, max_groups=8, top_k=GROUP_TOP_K)))
    return out


def plan_selection(values: np.ndarray, q: Query):
    """The query's lowered plan and the rows its predicate selects (float64
    comparisons; only the columns with a finite bound are tested, since
    every value passes -inf <= v < inf)."""
    plan = linear_plan([q], values.shape[1])
    sel = np.ones(len(values), bool)
    for c in range(values.shape[1]):
        if np.isfinite(plan.lo[0, c]):
            sel &= values[:, c] >= np.float64(plan.lo[0, c])
        if np.isfinite(plan.hi[0, c]):
            sel &= values[:, c] < np.float64(plan.hi[0, c])
    return plan, sel


def exact_answer(values: np.ndarray, q: Query) -> float:
    """The query's exact answer over ``values`` in float64 numpy."""
    plan, sel = plan_selection(values, q)
    x = values @ plan.coeffs[0].astype(np.float64)
    if q.agg == "count":
        return float(sel.sum())
    if q.agg == "sum":
        return float(x[sel].sum())
    return float(x[sel].mean())


def exact_answers(values: np.ndarray, queries) -> dict:
    """exact_answer of every query by name, each distinct coefficient row
    projected once."""
    proj, out = {}, {}
    for q in queries:
        plan, sel = plan_selection(values, q)
        key = plan.coeffs[0].tobytes()
        if key not in proj:
            proj[key] = values @ plan.coeffs[0].astype(np.float64)
        x = proj[key][sel]
        out[q.name] = float({"count": sel.sum(), "sum": x.sum(),
                             "avg": x.mean()}[q.agg])
    return out


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
def round_window(packed: torch.Tensor, sizes: np.ndarray, b: int,
                 rng: np.random.Generator, w: int = 4):
    """W random chunks of ``packed``, their permutation windows of width b
    at random cursors, and unequal budgets (one worker idle), none beyond
    its chunk: (jw, idx, b_eff) int32 on the card."""
    dev = packed.device
    n, m_max, _ = packed.shape
    jw = rng.choice(n, size=w, replace=False)
    off = rng.integers(0, sizes[jw])
    idx = permutation_window_dyn(
        chunk_seed(7, torch.as_tensor(jw, device=dev)),
        torch.as_tensor(off, device=dev), b,
        torch.as_tensor(sizes[jw], device=dev), m_max)
    b_eff = np.minimum([b, max(b - 3, 1), max(b // 2, 1), 0][:w], sizes[jw])
    return (torch.as_tensor(jw, dtype=torch.int32, device=dev),
            idx.to(torch.int32).contiguous(),
            torch.as_tensor(b_eff, dtype=torch.int32, device=dev))


def kernel_inputs(packed: torch.Tensor, sizes: np.ndarray, b: int,
                  rng: np.random.Generator, w: int = 4):
    """One round's kernel inputs at width ``b``: W random chunks, their
    permutation windows at random cursors, unequal budgets (one worker
    idle), and an 8-slot plan with non-unit weights, two gated-off slots
    and three COUNT slots.  Range bounds sit 500 away from any value of
    the dataset's value grid, so no predicate rides a parse rounding."""
    dev = packed.device
    c = packed.shape[2] // FIELD_BYTES
    jw, idx, b_eff = round_window(packed, sizes, b, rng, w)
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

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return (packed, jw, idx, b_eff, f32(coeffs), f32(lo), f32(hi),
            f32(is_count), f32(gate), f32(weights))


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
    got_stats, got_cols = same_bits(lambda: slot_extract_cuda(
        packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate, wts,
        return_cols=return_cols), f"slot_extract B={b}")
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
    for b in EDGE_B:
        inputs = kernel_inputs(packed, sizes, b, rng)
        for rc in (False, True):
            r = check_kernel(inputs, rc)
            rows.append(r)
            log(f"[kernel] slot_extract B={b} return_cols={rc}: m lane equal;"
                f" sums max rel err {r['max_rel_err_sums']:.3g} (rtol "
                f"{r['rtol_sums']:.3g}); cols max abs err "
                f"{r['max_abs_err_cols']}; 3 launches, same bits")
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
# digits), the three bitwise equalities of the module docstring, and every
# cache row off the window +0.0 in NaN-filled output memory (the wrappers
# allocate the cache with torch.empty and the kernels write every row).
def phase_stream_kernels(packed: torch.Tensor, sizes: np.ndarray) -> dict:
    rng = np.random.default_rng(13)
    out = {"stream": [], "decoded": [], "parse": []}
    c = packed.shape[2] // FIELD_BYTES
    for b in EDGE_B:
        inputs = kernel_inputs(packed, sizes, b, rng)
        slab, idx, b_eff, plan, mb = stream_inputs(inputs)
        coeffs, lo, hi, isc, gate, wts = plan
        args = (idx, b_eff, coeffs, lo, hi, isc, gate, wts, mb)
        got, rows = same_bits(lambda: slot_extract_stream_cuda(
            slab, *args, cache_cap=CACHE_CAP), f"slot_extract_stream B={b}")
        want = kref.slot_extract_stream_ref(slab, idx, b_eff, coeffs, lo, hi,
                                            isc, gate, num_cols=c,
                                            weights=wts)
        want_rows = kref.stream_cache_rows_ref(slab, idx, b_eff, mb,
                                               CACHE_CAP, c)
        w, r, rec = slab.shape
        dec = same_bits(lambda: extract_parse_cuda(
            slab.reshape(w * r, rec), c), "extract_parse")
        plain_dec = kref.parse_ascii_ref(slab.reshape(w * r, rec), c)
        dstats, drows = same_bits(lambda: slot_eval_decoded_cuda(
            dec.reshape(w, r, c), *args, cache_cap=CACHE_CAP),
            f"slot_eval_decoded B={b}")
        dwant = kref.slot_eval_decoded_ref(dec.reshape(w, r, c), idx, b_eff,
                                           coeffs, lo, hi, isc, gate,
                                           weights=wts)
        dwant_rows = kref.window_cache_rows_ref(
            kref.gather_window(dec.reshape(w, r, c), idx), b_eff, mb,
            CACHE_CAP)
        packed_stats, _ = slot_extract_cuda(*inputs)
        with dirty_empty():
            dirty = [fn(src, *args, cache_cap=CACHE_CAP) for fn, src in (
                (slot_extract_stream_cuda, slab),
                (slot_eval_decoded_cuda, dec.reshape(w, r, c)))]
        off = off_window(b, b_eff, mb, CACHE_CAP)
        is_dec = torch.tensor([True, False, False, True], device=slab.device)
        b_raw = torch.where(is_dec, torch.zeros_like(b_eff), b_eff)
        m1, mrows1 = slot_extract_stream_cuda(slab, idx, b_raw, *args[2:],
                                              cache_cap=CACHE_CAP)
        m2, mrows2 = slot_eval_decoded_cuda(dec.reshape(w, r, c), idx,
                                            b_eff - b_raw, *args[2:],
                                            cache_cap=CACHE_CAP)
        torch.cuda.synchronize()
        for (d_stats, d_rows), what, stats_, rows_ in zip(
                dirty, ("slot_extract_stream", "slot_eval_decoded"),
                (got, dstats), (rows, drows)):
            bits = d_rows.view(torch.int32).cpu().numpy()
            if (bits[off] != 0).any():
                raise AssertionError(f"{what} B={b}: a cache row off the "
                                     "window is not +0.0 in a dirty buffer")
            if not (torch.equal(d_stats, stats_)
                    and torch.equal(d_rows, rows_)):
                raise AssertionError(f"{what} B={b}: a dirty output buffer "
                                     "changed the result")
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
            f" == slab, mixed pair == single (stats and cache rows); 3 "
            f"launches of each kernel, same bits; {int(off.sum())} cache "
            f"rows off the window +0.0 in NaN-filled output memory")
        del slab, dec, plain_dec, dirty
    return out


# ------------------------------------------------------- grouped kernel ----
def group_columns(spec: list, g: int):
    """gcol (S,), gval/gact (S, G) for per-slot specs: None (ungrouped),
    "discover" (only __other__ live) or a list of tracked values (live, with
    __other__); the group column is column 0."""
    s = len(spec)
    gcol = np.full(s, -1, np.int32)
    gval = np.zeros((s, g), np.float32)
    gact = np.zeros((s, g), np.float32)
    for i, sp in enumerate(spec):
        if sp is None:
            continue
        gcol[i], gact[i, -1] = 0, 1.0
        if sp != "discover":
            gval[i, :len(sp)], gact[i, :len(sp)] = sp, 1.0
    return gcol, gval, gact


def wiki_plan():
    """The grouped deployment's slot shapes (S=4, C=4): SUM(hits) with three
    tracked languages, SUM(bytes) ungrouped, a COUNT (hour < 400) that
    discovers, SUM(hits | hits > 3) with all eight cells tracked at weight
    0.77.  Bounds sit half-way between the integer hours and hits."""
    coeffs = np.zeros((4, 4), np.float32)
    lo = np.full((4, 4), -np.inf, np.float32)
    hi = np.full((4, 4), np.inf, np.float32)
    coeffs[0, 1] = coeffs[3, 1] = coeffs[1, 2] = 1.0
    hi[2, 3] = 400.5
    lo[3, 1] = 3.5
    plan = (coeffs, lo, hi, np.asarray([0, 0, 1, 0], np.float32),
            np.ones(4, np.float32), np.asarray([1, 1, 1, 0.77], np.float32))
    return plan, [[0.0, 1.0, 2.0], None, "discover", list(range(8))]


MAIN_GROUP_SPEC = [[0.0, 1.0, 2.0, 3.0], None, "discover", None,
                   list(range(8)), None, [1.0], [5.0]]


def lang_store_packed(n: int = 8, m: int = 8192, langs: int = 40):
    """A (n, m, 256) packed store at the main store's widths whose column 0
    is an integer language id (Zipf 1.1 over ``langs``) and whose other
    columns are the paper's synthetic Zipf columns: the group column the
    tallies are bit-exact on."""
    rng = np.random.default_rng(23)
    vals = make_synthetic_zipf(num_tuples=n * m, num_cols=NUM_COLS, seed=23)
    w = np.arange(1, langs + 1, dtype=np.float64) ** -1.1
    vals[:, 0] = rng.choice(langs, size=n * m, p=w / w.sum())
    store = store_dataset(vals, num_chunks=n, fmt="ascii")
    packed, sizes = store.packed_device_view("cuda")
    return packed, np.asarray(sizes)


def grouped_case(packed, sizes, b, rng, shape: str):
    """One round's grouped-kernel inputs on the card: ``shape`` "deployment"
    (the wiki store, S=4, G=9, C=4) or "main" (C=16, S=8, G=9: kernel
    1's plan with grouped, ungrouped and discovery-only slots)."""
    dev = packed.device
    if shape == "main":
        inp = kernel_inputs(packed, sizes, b, rng)
        spec = MAIN_GROUP_SPEC
        base = list(inp)
    else:
        jw, idx, b_eff = round_window(packed, sizes, b, rng)
        (coeffs, lo, hi, isc, gate, wts), spec = wiki_plan()
        base = [packed, jw, idx, b_eff] + [
            torch.as_tensor(a, device=dev)
            for a in (coeffs, lo, hi, isc, gate, wts)]
    gcol, gval, gact = group_columns(spec, 9)
    groups = [torch.as_tensor(a, device=dev) for a in (gcol, gval, gact)]
    salt = torch.tensor([int(rng.integers(0, 2 ** 31))], dtype=torch.int32,
                        device=dev)
    return base, groups, salt


def fanout_plan(base, groups):
    """Kernel 1's plan for the group_fanout slots of every live tracked cell
    (the slot's predicate ∧ col == v, lowered as [v, nextafter(v))) and the
    (slot, cell) each fan-out slot stands for."""
    coeffs, lo, hi, isc, gate, wts = (t.cpu().numpy() for t in base[4:10])
    gcol, gval, gact = (t.cpu().numpy() for t in groups)
    rows, cells = [], []
    for s_i in np.flatnonzero(gcol >= 0):
        for g_i in np.flatnonzero(gact[s_i, :-1] > 0):
            v = np.float32(gval[s_i, g_i])
            c = gcol[s_i]
            l, h = lo[s_i].copy(), hi[s_i].copy()
            l[c] = max(l[c], v)
            h[c] = min(h[c], np.nextafter(v, np.float32(np.inf)))
            rows.append((coeffs[s_i], l, h, isc[s_i], gate[s_i], wts[s_i]))
            cells.append((s_i, g_i))
    dev = base[0].device
    plan = [torch.as_tensor(np.stack([r[k] for r in rows]).astype(np.float32),
                            device=dev) for k in range(6)]
    return plan, cells


# The grouped kernel against its plain version: the m lane and the cells'
# count lanes equal; the sum lanes of stats and cells within (2B+16)·2^-24
# relative (non-negative terms; see check_kernel); the decoded window within
# 2^-21·|v| + 1e-6; the tallies bit for bit (an integer group column and
# 0/1 indicators: every tally sum is exact in float32 in any order).  Then
# the tracked cells' three sum lanes equal, bit for bit, kernel 1 on the
# group_fanout slots of the same inputs (every mask factor is an exact 0/1
# float and both reduce in one order).
def phase_grouped_kernels(gpacked, gsizes, lpacked, lsizes) -> list[dict]:
    rng = np.random.default_rng(29)
    rows = []
    for shape, packed, sizes in (("deployment", gpacked, gsizes),
                                 ("main", lpacked, lsizes)):
        c = packed.shape[2] // FIELD_BYTES
        for b in EDGE_B:
            base, groups, salt = grouped_case(packed, sizes, b, rng, shape)
            st, cols, gs, tal = same_bits(lambda: slot_extract_grouped_cuda(
                *base, *groups, salt, kref.TALLY_BUCKETS, return_cols=True),
                f"slot_extract_grouped {shape} B={b}")
            pst, pcols, pgs, ptal = kref.slot_extract_grouped_ref(
                *base[:9], *groups, salt, num_cols=c, return_cols=True,
                weights=base[9])
            fplan, cells = fanout_plan(base, groups)
            fst, _ = slot_extract_cuda(*base[:4], *fplan)
            torch.cuda.synchronize()
            h = {k: v.cpu().numpy() for k, v in dict(
                st=st, pst=pst, gs=gs, pgs=pgs, tal=tal, ptal=ptal,
                cols=cols, pcols=pcols, fst=fst).items()}
            rel = check_sums(h["st"], h["pst"], b, f"grouped {shape} stats")
            grel = check_sums(h["gs"], h["pgs"], b, f"grouped {shape} cells")
            if not np.array_equal(h["tal"], h["ptal"]):
                raise AssertionError(f"grouped {shape} B={b}: tallies differ "
                                     "from the plain version")
            lim = 2.0 ** -21 * np.abs(h["pcols"]) + 1e-6
            if (np.abs(h["cols"] - h["pcols"]) > lim).any():
                raise AssertionError(f"grouped {shape} B={b}: cols differ "
                                     "beyond 2^-21·|v|+1e-6")
            for f, (s_i, g_i) in enumerate(cells):
                if not np.array_equal(h["gs"][:, s_i, g_i, 1:],
                                      h["fst"][:, f, 1:]):
                    raise AssertionError(
                        f"grouped {shape} B={b}: cell ({s_i}, {g_i}) != "
                        "kernel 1 on its fan-out slot")
            if not h["tal"].any():
                raise AssertionError(f"grouped {shape} B={b}: no tallies")
            rows.append(dict(
                shape=shape, B=b, max_rel_err_sums=max(rel, grel),
                max_abs_err=float(np.max(np.abs(h["cols"] - h["pcols"]))),
                fanout_cells=len(cells)))
            log(f"[grouped-kernel] {shape} B={b}: m and cell counts equal; "
                f"sums max rel err {max(rel, grel):.3g} (rtol "
                f"{(2 * b + 16) * 2.0 ** -24:.3g}); tallies bit for bit "
                f"({int(h['tal'][..., 0, :].sum())} rows tallied); "
                f"{len(cells)} tracked cells == kernel 1 on their fan-out "
                "slots, bit for bit; 3 launches, same bits")
    return rows


# ---------------------------------------------------------- rows kernels ----
def deployment_plan(values: np.ndarray):
    """The deployment's eight queries lowered to (Q, C) coeffs/lo/hi."""
    qs = deployment_queries(values)
    lp = linear_plan(qs, values.shape[1])
    return qs, [torch.as_tensor(a, device="cuda")
                for a in (lp.coeffs, lp.lo, lp.hi)]


def plain_chunk_agg(packed, sizes_t, plan, batch: int = 8) -> torch.Tensor:
    """The plain version over the whole store, ``batch`` chunks a call
    (its per-digit parse holds ~256 bytes per field in flight)."""
    c = packed.shape[2] // FIELD_BYTES
    return torch.cat([kref.chunk_agg_ref(packed[i:i + batch], c, *plan,
                                         sizes_t[i:i + batch])
                      for i in range(0, packed.shape[0], batch)])


def parse_slack(values: np.ndarray, q: Query):
    """Rows whose predicate the float32 parse may decide otherwise than
    float64 does: a constrained value within one float32 spacing of its
    bound but not equal to it (the bounds are integers, and an integer
    equal to one parses exactly).  Returns (Σ|x| over them, their count)
    for the query's plan."""
    plan = linear_plan([q], values.shape[1])
    near = np.zeros(len(values), bool)
    for bounds in (plan.lo[0], plan.hi[0]):
        for c in np.flatnonzero(np.isfinite(bounds)):
            b = np.float64(bounds[c])
            gap = np.float64(np.spacing(np.abs(bounds[c])))
            d = np.abs(values[:, c] - b)
            near |= (d <= gap) & (d > 0)
    x = values[near] @ plan.coeffs[0].astype(np.float64)
    return float(np.abs(x).sum()), int(near.sum())


# chunk_agg over the whole packed store with the deployment's plans, through
# ops.chunk_agg (the entry point): the count lanes equal the chunk sizes,
# the kernel's lanes are within (2M+16)·2^-24 relative of the plain
# version's (the count and Σp lanes exactly), and its per-query totals,
# added over chunks in float64, agree with exact_answer's float64 answers
# within (M/256 + 64)·2^-24 of Σ|x| (each term carries the parse's and the
# linear expression's few roundings, and a chunk's sum is a chain of the
# rows a thread sums, 5 shuffle levels, 4 warps and the P blocks the chunk
# is split over: rows_split's chain_depth, held here to that allowance)
# plus the rows the float32 parse may move across a predicate bound (the
# dataset's values are multiples of 999.99, so the parse rounds them;
# parse_slack counts those rows).  round_stats at (4, 4096, 256) on a
# round's gathered window, through ops.round_stats, against its plain
# version as for slot_extract.
def phase_rows_kernels(packed, sizes: np.ndarray, values: np.ndarray) -> dict:
    qs, plan = deployment_plan(values)
    sizes_t = torch.as_tensor(sizes, dtype=torch.int32, device="cuda")
    n, m_max, rec = packed.shape
    splits = {}
    for name, (l, r) in (("chunk_agg", (n, m_max)), ("round_stats", (4, 4096))):
        c, q = rec // FIELD_BYTES, plan[0].shape[0]
        sp = splits[name] = launch_split(name, l, r, c, q, packed.device)
        if sp.chain_depth > r // 256 + 64:
            raise AssertionError(f"{name}: a sum's rounding chain of "
                                 f"{sp.chain_depth} additions exceeds the "
                                 f"tolerance's {r // 256 + 64}")
    reset_launches()
    out = ops.chunk_agg(packed, sizes_t, *plan)
    torch.cuda.synchronize()
    agg_launches = chunk_agg_cuda.launches
    same_bits(lambda: ops.chunk_agg(packed, sizes_t, *plan), "chunk_agg",
              first=out)
    plain = plain_chunk_agg(packed, sizes_t, plan)
    torch.cuda.synchronize()
    got, want = out.cpu().numpy(), plain.cpu().numpy()
    if not np.array_equal(got[..., 0], np.broadcast_to(
            sizes[:, None], got.shape[:2])):
        raise AssertionError("chunk_agg: count lanes != chunk sizes")
    rel = check_sums(got, want, m_max, "chunk_agg")
    if not np.array_equal(got[..., 3], want[..., 3]):
        raise AssertionError("chunk_agg: Σp lane differs from the plain one")
    rtol = (m_max // 256 + 64) * 2.0 ** -24
    tot = got.astype(np.float64).sum(0)                      # (Q, 4)
    worst = 0.0
    for qi, q in enumerate(qs):
        exact = exact_answer(values, q)
        slack_x, slack_n = parse_slack(values, q)
        lp, sel = plan_selection(values, q)
        abs_x = float(np.abs(values[sel] @ lp.coeffs[0].astype(
            np.float64)).sum())
        tol_x, tol_n = rtol * abs_x + slack_x, float(slack_n)
        est = {"sum": tot[qi, 1], "count": tot[qi, 3],
               "avg": tot[qi, 1] / tot[qi, 3]}[q.agg]
        tol = {"sum": tol_x, "count": tol_n,
               "avg": (tol_x + abs(exact) * tol_n) / tot[qi, 3]}[q.agg]
        dev = abs(est - exact)
        worst = max(worst, dev / abs(exact))
        log(f"[rows] chunk_agg {q.name:>16}: {est:.10g} vs exact "
            f"{exact:.10g} (|diff| {dev:.4g}, tol {tol:.4g}: {slack_n} rows "
            f"within a float32 spacing of a bound)")
        if dev > tol:
            raise AssertionError(f"chunk_agg {q.name}: |diff| {dev:.4g} > "
                                 f"{tol:.4g}")
    rng = np.random.default_rng(31)
    jw, idx, b_eff = round_window(packed, sizes, 4096, rng)
    slab = packed[jw.long()[:, None], idx.long()].contiguous()
    reset_launches()
    rs = ops.round_stats(slab, b_eff, *plan)
    torch.cuda.synchronize()
    rs_launches = round_stats_cuda.launches
    same_bits(lambda: ops.round_stats(slab, b_eff, *plan), "round_stats",
              first=rs)
    prs = kref.round_stats_ref(slab, rec // FIELD_BYTES, *plan, b_eff)
    rs_rel = check_sums(rs.cpu().numpy(), prs.cpu().numpy(), 4096,
                        "round_stats")
    for name, sp in splits.items():
        log(f"[rows] {name}: {sp.blocks} blocks a row block, {sp.steps} "
            f"steps of {sp.step_rows} rows a block, rounding chain "
            f"{sp.chain_depth} additions")
    log(f"[rows] chunk_agg over {n} chunks ({int(sizes.sum())} rows): count "
        f"lanes == sizes, sums max rel err {rel:.3g} vs the plain version "
        f"(rtol {(2 * m_max + 16) * 2.0 ** -24:.3g}), totals within "
        f"{worst:.3g} relative of float64; round_stats at "
        f"{tuple(slab.shape)}: m lane equal, sums max rel err {rs_rel:.3g}")
    return dict(chunk_agg_launches=agg_launches, chunk_agg_rel=rel,
                chunk_agg_exact_rel=worst, round_stats_launches=rs_launches,
                round_stats_rel=rs_rel, plan=plan, sizes_t=sizes_t,
                max_abs_err=float(np.max(np.abs(got - want))),
                rs_max_abs_err=float(np.max(np.abs(
                    rs.cpu().numpy() - prs.cpu().numpy()))))


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
    cut = {}    # the state and answers after CUT_ROUNDS rounds

    def on_round(srv):
        rungs.append(srv.engine.budget_ladder(float(srv.state.budget)))
        if srv.rounds == CUT_ROUNDS:
            cut.update(state=spmd_record(srv.engine, srv.state),
                       results=result_rows(srv.results))

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
                peak=peak, cut=cut)


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


# ---------------------------------------------------------- serving plane ----
def ptf_queries() -> list[Query]:
    """examples/explore_ptf.py's three verification checks."""
    return [
        Query(agg="avg", expr=Column(4), pred=TRUE,
              having=Having("<", 0.05), epsilon=0.05,
              name="avg_mag_err<0.05"),
        Query(agg="count", pred=Range(3, 0.0, 17.0),
              having=Having(">", 500.0), epsilon=0.05, name="bright>500"),
        Query(agg="avg", expr=Column(3), pred=TRUE,
              having=Having("<", 22.0), epsilon=0.05, name="avg_mag<22"),
    ]


def having_holds(q: Query, v: float) -> bool:
    t = q.having.threshold
    return {"<": v < t, "<=": v <= t, ">": v > t, ">=": v >= t}[q.having.op]


def check_chain(values: np.ndarray, results, tag: str) -> None:
    """Every verdict is the float64 truth's (an undecided verdict is judged
    on the point estimate, as the chain does) and the chain stops where the
    truth says it stops."""
    queries = ptf_queries()
    truth = [having_holds(q, exact_answer(values, q)) for q in queries]
    want_len = next((i + 1 for i, t in enumerate(truth) if not t),
                    len(queries))
    for q, r, t in zip(queries, results, truth):
        verdict = int(r.decisions[0])
        est = float(r.final_estimate[0])
        log(f"[ptf] {tag} {q.name:>18}: verdict {verdict:2d} estimate "
            f"{est:.7g} exact {exact_answer(values, q):.7g} rounds "
            f"{r.rounds} tuples {100 * r.tuples_ratio:.3f}% synopsis "
            f"{r.from_synopsis}")
        passed = verdict == 1 or (verdict == -1 and having_holds(q, est))
        if passed != t:
            raise AssertionError(f"[ptf] {tag} {q.name}: verdict {verdict} "
                                 f"but the float64 truth says {t}")
    if len(results) != want_len:
        raise AssertionError(f"[ptf] {tag}: the chain ran {len(results)} "
                             f"queries, the truth stops after {want_len}")


def run_chain(store, device: str, **engine):
    ctrl = EstimationController(store, EngineConfig(**PTF_ENGINE, **engine),
                                synopsis_budget_tuples=PTF_SYNOPSIS,
                                device=device)
    return ctrl.run_verification(ptf_queries())


def phase_ptf() -> dict:
    """The paper's verification chain on the frozen plane: explore_ptf.py's
    batch (binary records, so the ``ref`` extraction path) card against
    CPU, then the same checks over a fixed-width ASCII PTF-like table on
    the card, through kernel 1."""
    values = make_ptf_like(PTF["tuples"], PTF["chunks"], seed=PTF["seed"])
    store = store_dataset(values, num_chunks=PTF["chunks"], fmt="binary")
    t0 = time.perf_counter()
    card = run_chain(store, "cuda", extract_backend="ref")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = run_chain(store, "cpu", extract_backend="ref")
    if len(card) != len(cpu):
        raise AssertionError("[ptf] card and cpu chains stop at different "
                             "queries")
    for q, a, b in zip(ptf_queries(), card, cpu):
        if not (np.array_equal(a.decisions, b.decisions)
                and np.array_equal(a.stopped, b.stopped)
                and (a.rounds, a.tuples_ratio, a.chunks_ratio,
                     a.from_synopsis) == (b.rounds, b.tuples_ratio,
                                          b.chunks_ratio, b.from_synopsis)):
            raise AssertionError(f"[ptf] {q.name}: card and cpu differ")
    check_chain(values, card, "binary card")
    log(f"[ptf] binary batch ({store.num_tuples} tuples, {store.num_chunks} "
        f"chunks): card == cpu in verdicts, stop, rounds and tuples over "
        f"{len(card)} queries, {sum(r.rounds for r in card)} rounds, "
        f"{card_s:.2f} s on the card")

    t0 = time.perf_counter()
    values = make_ptf_like(PTF_ASCII["tuples"], PTF_ASCII["chunks"],
                           seed=PTF["seed"])
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        store = store_dataset(values, num_chunks=PTF_ASCII["chunks"],
                              fmt="ascii", encode_map=pool.map)
    log(f"[ptf] ASCII table: {store.num_tuples} tuples x 8 columns, "
        f"{store.num_chunks} chunks, {store.codec.record_bytes}-byte records "
        f"({store.num_tuples * store.codec.record_bytes / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")
    reset_launches()
    t0 = time.perf_counter()
    results = run_chain(store, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_chain(values, results, "ascii card")
    rounds = sum(r.rounds for r in results)
    launches = counts["slot_extract"]
    log(f"[ptf] ASCII chain: {len(results)} queries, {rounds} rounds, "
        f"kernel 1 launches {launches}, wall {wall:.3f} s "
        f"({wall / max(rounds, 1) * 1e3:.3f} ms per round; each query "
        f"builds its engine and packs the store)")
    if launches != rounds or sum(counts.values()) != launches:
        raise AssertionError(f"[ptf] kernel 1 launches {launches} != rounds "
                             f"{rounds}, or another kernel ran: {counts}")
    return dict(rounds=rounds, launches=launches, wall_s=wall)


def attach_slos(queries, t_full: float, seed: int) -> list:
    """bench_workload.py's SLO mix: priorities batch/normal/interactive
    with p = 0.3/0.5/0.2, deadlines U(0.15, 2.5) x the modeled full-scan
    time."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in queries:
        pri = str(rng.choice(["batch", "normal", "interactive"],
                             p=[0.3, 0.5, 0.2]))
        dl = float(rng.uniform(0.15, 2.5)) * t_full
        out.append(QuerySLO(deadline_s=dl, priority=pri))
    return out


SCHED_TRACE = ("cur", "head", "offset", "scan_m", "closed", "schedule",
               "stopped")
SCHED_FLOATS = ("budget", "t_io", "t_cpu")


def sched_trace(trace: list, floats: bool):
    """on_round recording a server's integer state (and, with ``floats``,
    its float state) and the slot table's weights after every round."""
    def on_round(srv):
        st = srv.state
        rec = {f: getattr(st, f).cpu().numpy() for f in SCHED_TRACE}
        # every worker's claim (under a mesh state.cur is the rank's)
        rec["cur"] = srv.engine.coll.gather_workers(st.cur).cpu().numpy()
        rec["stats.m"] = st.stats.m.cpu().numpy()
        rec["weight"] = srv.table.weight.cpu().numpy()
        if floats:
            for f in SCHED_FLOATS:
                rec[f] = getattr(st, f).cpu().numpy()
            for f in ("ysum", "ysq", "psum"):
                rec[f"stats.{f}"] = getattr(st.stats, f).cpu().numpy()
        trace.append(rec)
    return on_round


def parity_slo_workload(values) -> list:
    """small_workload with SLOs: a batch SUM, an interactive COUNT, an
    interactive HAVING query with a deadline, a normal AVG and a tight SUM
    with no SLO."""
    slos = [QuerySLO(priority="batch"), QuerySLO(priority="interactive"),
            QuerySLO(priority="interactive", deadline_s=0.05),
            QuerySLO(priority="normal"), None]
    return [(q, at, slo) for (q, at), slo in zip(small_workload(values),
                                                 slos)]


def topup_phases() -> list:
    """test_sched.py's variance top-up workload with SLOs: a near-certain
    COUNT closes chunks early, then a tight SUM and two more queries drive
    the scan into a top-up pass, where the variance order reorders the
    re-opened tail."""
    coef = tuple(1.0 / (k + 1) for k in range(8))

    def total(name, eps):
        return Query(agg="sum", expr=Linear(coef), epsilon=eps, name=name)

    return [
        [(Query(agg="count", pred=Range(0, 0.0, 1e12), epsilon=0.02,
                name="loose"), 0.0, None, "single_pass")],
        [(total("tight", 0.005), None, QuerySLO(priority="interactive"),
          "single_pass"),
         (total("bat", 0.01), None, QuerySLO(priority="batch"), None),
         (Query(agg="avg", expr=Linear(coef), epsilon=0.01, name="d"), None,
          QuerySLO(priority="interactive", deadline_s=5e-3), None)],
    ]


def serve_traced(store, device: str, scheduler, phases, floats: bool,
                 residency: str = "packed",
                 engine=dict(num_workers=4, seed=7), mesh=None) -> dict:
    """Serve ``phases`` (lists of (query, arrival, slo, plan) items, each
    submitted once the previous one has run out) with max_slots=2: the
    per-round trace, the results, and the claim keys the scheduler
    computed before each round."""
    keys = []
    if scheduler is not None:
        order = scheduler.claim_order

        def claim_order(state, sizes, active=None, slot_need=None):
            keys.append(slot_chunk_variances(state, active, slot_need))
            return order(state, sizes, active, slot_need)

        scheduler.claim_order = claim_order
    trace = []
    with OLAWorkloadServer(
            store, EngineConfig(residency=residency, **engine),
            options=ServerOptions(max_slots=2, scheduler=scheduler,
                                  mesh=mesh),
            device=device) as server:
        hooks = hook_timer(server, ("_apply_scheduling", "_admit_ready"))
        t0 = time.perf_counter()
        for phase in phases:
            for q, at, slo, plan in phase:
                server.submit(q, arrival_t=at, slo=slo, plan=plan)
            server.run(on_round=sched_trace(trace, floats))
        wall = time.perf_counter() - t0
        return dict(trace=trace, results=sorted(server.results,
                                                key=lambda r: r.qid),
                    rounds=server.rounds, keys=keys, wall_s=wall,
                    hooks_s=hooks["s"],
                    shed=server.shed_count, preempt=server.preempt_count,
                    topups=server.topup_passes)


RESULT_INTS = ("qid", "name", "plan", "sched_outcome", "slo_met",
               "rounds_resident", "tuples_seen", "seeded_tuples", "decision",
               "unserved")
RESULT_FLOATS = ("estimate", "lo", "hi", "err", "t_admit", "t_done")
# the near-tie tolerance of two claim keys (float32 relative)
F32_RTOL = 1e-5


def first_divergence(a: list, b: list):
    """The first round whose integer state differs, or None."""
    for r, (x, y) in enumerate(zip(a, b)):
        for f in SCHED_TRACE + ("stats.m",):
            if not np.array_equal(x[f], y[f]):
                return r
    return None if len(a) == len(b) else min(len(a), len(b))


def bitwise_equal(a: dict, b: dict, what: str) -> None:
    if a["rounds"] != b["rounds"] or len(a["trace"]) != len(b["trace"]):
        raise AssertionError(f"{what}: rounds differ")
    for r, (x, y) in enumerate(zip(a["trace"], b["trace"])):
        for f in x:
            if not np.array_equal(x[f], y[f]):
                raise AssertionError(f"{what}: round {r}: {f} differs")
    for p, q in zip(a["results"], b["results"], strict=True):
        for f in RESULT_INTS + RESULT_FLOATS:
            u, v = getattr(p, f), getattr(q, f)
            if not (u == v or (u != u and v != v)):
                raise AssertionError(f"{what}: {p.name}: {f} differs")


def near_tie(card: dict, cpu: dict, first: int) -> tuple:
    """At the first divergent round the claim orders must differ, and the
    first two chunks they swap must have keys within F32_RTOL of each
    other in both runs."""
    sa = card["trace"][first]["schedule"]
    sb = cpu["trace"][first]["schedule"]
    if np.array_equal(sa, sb):
        raise AssertionError(f"[sched-parity] variance: integer state "
                             f"diverged at round {first} under the same "
                             "claim order")
    p = int(np.flatnonzero(sa != sb)[0])
    ja, jb = int(sa[p]), int(sb[p])
    for k in (card["keys"][first], cpu["keys"][first]):
        scale = max(abs(k[ja]), abs(k[jb]), 1e-30)
        if abs(k[ja] - k[jb]) > F32_RTOL * scale:
            raise AssertionError(
                f"[sched-parity] variance: round {first} swapped chunks "
                f"{ja} and {jb} with keys {k[ja]!r} and {k[jb]!r}: not a "
                "near tie")
    return p, ja, jb


def phase_sched_parity() -> dict:
    """The scheduler on the card against the CPU on the small example table
    with SLOs (max_slots=2, SchedulerConfig(slot_capacity=1.0,
    preempt=True)): integer state equal every round under the committed
    claim order; under the variance order equal up to the first round the
    orders differ, where the swapped chunks' keys must be a near tie, and
    every answer that retired on its own within 3·ε after it.  Then, on
    the card, bit for bit: NEUTRAL == unscheduled, scheduled stream ==
    scheduled packed."""
    values = make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)
    store = store_dataset(values, num_chunks=64, fmt="ascii")
    work = [[(q, at, slo, None)
             for q, at, slo in parity_slo_workload(values)]]
    tvalues = make_synthetic_zipf(num_tuples=4096, num_cols=8, seed=3)
    tstore = store_dataset(tvalues, num_chunks=32, fmt="ascii")
    topup = dict(engine=dict(num_workers=2, seed=29))
    cases = {
        "schedule": (store, values, work, {}),
        "variance": (store, values, work, {}),
        "variance, top-up": (tstore, tvalues, topup_phases(), topup),
    }
    out = {}
    for case, (st, vals, phases, kw) in cases.items():
        policy = case.split(",")[0]
        runs = {}
        for dev in ("cuda", "cpu"):
            sched = WorkloadScheduler(SchedulerConfig(
                slot_capacity=1.0, preempt=True, claim_policy=policy))
            runs[dev] = serve_traced(st, dev, sched, phases, floats=False,
                                     **kw)
        card, cpu = runs["cuda"], runs["cpu"]
        first = first_divergence(card["trace"], cpu["trace"])
        col = [t["schedule"] for t in card["trace"]]
        reorders = sum(not np.array_equal(s, col[0]) for s in col)
        contended = sum(bool((t["weight"] < 1).any())
                        for t in card["trace"])
        facts = (f"{card['rounds']} rounds ({contended} with a weight below "
                 f"1, {reorders} with a reordered claim tail, top-up passes "
                 f"{card['topups']}, shed {card['shed']}, preempted "
                 f"{card['preempt']}); on the card "
                 f"{card['wall_s'] / card['rounds'] * 1e3:.3f} ms per round "
                 f"with the per-round trace, scheduler hooks and intake "
                 f"{card['hooks_s'] / card['rounds'] * 1e3:.4f} ms host per "
                 "round")
        if first is None:
            for a, b in zip(card["results"], cpu["results"], strict=True):
                for f in RESULT_INTS:
                    if getattr(a, f) != getattr(b, f):
                        raise AssertionError(f"[sched-parity] {case}: "
                                             f"{a.name}: {f} differs")
            log(f"[sched-parity] {case}: card == cpu on integer state and "
                f"per-query outcomes over {facts}")
        elif policy == "schedule":
            raise AssertionError(f"[sched-parity] {case}: card and cpu "
                                 f"diverge at round {first}")
        else:
            p, ja, jb = near_tie(card, cpu, first)
            log(f"[sched-parity] {case}: card and cpu equal up to round "
                f"{first}, where the claim orders swap chunks {ja} and {jb} "
                f"at position {p} on a near tie of their keys; {facts}")
            results = {r.name: r for r in card["results"]}
            for q in [x[0] for phase in phases for x in phase]:
                r = results[q.name]
                retired = (r.sched_outcome in ("admitted", "queued",
                                               "preempted")
                           and not r.unserved and r.err <= q.epsilon)
                ex = exact_answer(vals, q)
                if retired and abs(r.estimate - ex) > 3 * q.epsilon * abs(ex):
                    raise AssertionError(f"[sched-parity] {case}: {r.name} "
                                         "outside 3·eps")
        for r in card["results"]:
            log(f"[sched-parity] {case} {r.name:>14} {r.sched_outcome:>9} "
                f"slo_met {str(r.slo_met):>5} rounds {r.rounds_resident:3d} "
                f"seen {r.tuples_seen:5d} estimate {r.estimate:.7g}")
        out[case] = dict(rounds=card["rounds"], first=first,
                         reorders=reorders, contended=contended)
    if not out["variance, top-up"]["reorders"]:
        raise AssertionError("[sched-parity] the top-up workload never "
                             "reordered the claim tail")
    plain = [[(q, at, None, None) for q, at, _, _ in work[0]]]
    base = serve_traced(store, "cuda", None, plain, floats=True)
    neutral = serve_traced(store, "cuda", WorkloadScheduler(NEUTRAL), plain,
                           floats=True)
    # the streamed run under the variance order on the top-up workload,
    # where the tail is reordered between rounds
    streamed = {residency: serve_traced(
        tstore, "cuda", WorkloadScheduler(SchedulerConfig(
            slot_capacity=1.0, preempt=True)), topup_phases(), floats=True,
        residency=residency, **topup)
        for residency in ("packed", "stream")}
    bitwise_equal(streamed["stream"], streamed["packed"],
                  "[sched-parity] scheduled stream vs packed, top-up")
    bitwise_equal(neutral, base, "[sched-parity] NEUTRAL vs unscheduled")
    runs = {residency: serve_traced(
        store, "cuda", WorkloadScheduler(SchedulerConfig(
            slot_capacity=1.0, preempt=True)), work, floats=True,
        residency=residency) for residency in ("packed", "stream")}
    bitwise_equal(runs["stream"], runs["packed"],
                  "[sched-parity] scheduled stream vs packed")
    log(f"[sched-parity] on the card, bit for bit: NEUTRAL == unscheduled "
        f"({base['rounds']} rounds); scheduled stream == scheduled packed "
        f"({runs['packed']['rounds']} rounds, and "
        f"{streamed['packed']['rounds']} on the top-up workload, variance "
        "claims)")
    return out


def hook_timer(server, names: tuple) -> dict:
    """Accumulate the host seconds spent in the server methods ``names``."""
    spent = {"s": 0.0}
    for name in names:
        fn = getattr(server, name)

        def timed(*args, _fn=fn, **kw):
            t = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                spent["s"] += time.perf_counter() - t

        setattr(server, name, timed)
    return spent


@contextlib.contextmanager
def resident(store, packed: torch.Tensor):
    """Meanwhile a server built over ``store`` takes ``packed``, the copy
    already on the card, instead of packing the store again."""
    store.packed_device_view = lambda device: (packed, store.chunk_sizes)
    try:
        yield
    finally:
        del store.packed_device_view


@contextlib.contextmanager
def capture_kernel1(pred):
    """Meanwhile the arguments of the first ``ops.slot_extract`` call that
    satisfies ``pred`` are kept (all but the store cloned)."""
    kept = {}
    fn = ops.slot_extract

    def wrapped(*args, **kw):
        if not kept and pred(*args, **kw):
            kept["args"] = tuple(a.clone() if i and isinstance(
                a, torch.Tensor) else a for i, a in enumerate(args))
            kept["kw"] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in kw.items()}
        return fn(*args, **kw)

    ops.slot_extract = wrapped
    try:
        yield kept
    finally:
        ops.slot_extract = fn


# TRACE_LOSS: on an H100 80GB HBM3 at 700 W (torch 2.11, CUDA 12.8) a
# torch.profiler trace of 200 calls of kernel 1 held all 200 launches at
# the first trace of a process, 199 about 15 s later, 198 after 30 s, 191
# after two minutes and 190 after 130 s, every launch really made (the
# launch counters and launches == rounds say so); idle margins of 50 ms at
# both ends of the trace did not help.  A count taken late in the smoke is
# therefore taken in a fresh process.
FRESH_TRACE = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as m
d = torch.load(sys.argv[2])
inputs = [t.cuda() for t in d["inputs"]]
ms, per_call = m.device_ms(
    lambda _: m.slot_extract_cuda(*inputs, return_cols=d["return_cols"]),
    d["iters"], ("slot_extract_tiles",))
print(json.dumps({"ms": ms, "per_call": per_call}))
"""


def fresh_kernel1_trace(inputs, return_cols: bool, iters: int) -> dict:
    """device_ms of kernel 1 on ``inputs`` in a fresh process (the first
    trace of a process keeps every launch, see TRACE_LOSS): the store cut
    to the window's chunks, traced up to three times until the count of
    device activities is a whole number per call."""
    packed, jw, *rest = inputs
    small = packed[jw.long()].contiguous()          # (W, M_max, rec)
    ids = torch.arange(jw.shape[0], dtype=torch.int32, device=jw.device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "inputs.pt")
        torch.save({"inputs": [t.cpu() for t in (small, ids, *rest)],
                    "return_cols": return_cols, "iters": iters}, path)
        for attempt in range(3):
            out = subprocess.run(
                [sys.executable, "-c", FRESH_TRACE, REPO, path],
                capture_output=True, text=True, timeout=300, check=True)
            t = json.loads(out.stdout.strip().splitlines()[-1])
            if t["per_call"] is not None and t["per_call"] == round(
                    t["per_call"]):
                break
            log(f"[times] slot_extract: fresh trace {attempt + 1} lost "
                f"events ({t['per_call']} device activities per call)")
    return t


def served_kernel_check(kept: dict, tag: str) -> dict:
    """Kernel 1 on a served round's own inputs: against its plain version
    (check_kernel's tolerances, three launches with the same bits) and one
    device kernel per call, counted in a fresh process."""
    packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate = kept["args"]
    kw = kept["kw"]

    def i32(t):
        return t.to(torch.int32).contiguous()

    def f32(t):
        return t.to(torch.float32).contiguous()

    inputs = (packed, i32(jw), i32(idx), i32(b_eff), f32(coeffs), f32(lo),
              f32(hi), f32(isc), f32(gate), f32(kw["weights"]))
    rc = bool(kw.get("return_cols", False))
    row = check_kernel(inputs, rc)

    fresh = fresh_kernel1_trace(inputs, rc, 50)
    one_launch("slot_extract", fresh["per_call"])
    t = dict(device_ms=fresh["ms"], kernels_per_call=fresh["per_call"],
             call_ms=time_cuda(lambda _: slot_extract_cuda(
                 *inputs, return_cols=rc), 50))
    weights = np.round(kw["weights"].cpu().numpy(), 4).tolist()
    log(f"[{tag}] kernel 1 on a served round's inputs (B={idx.shape[1]}, "
        f"weights {weights}): m lane equal, sums max rel err "
        f"{row['max_rel_err_sums']:.3g} (rtol {row['rtol_sums']:.3g}), 3 "
        f"launches with the same bits; {t['kernels_per_call']} device "
        f"kernel(s) per call and {us(t['device_ms'])} us device time per "
        f"launch (traced in a fresh process, the store cut to the window's "
        f"{jw.shape[0]} chunks)")
    return dict(row, **t)


def phase_sched(store, values, packed) -> dict:
    """The scheduled deployment: the packed deployment's table and queries
    with bench_workload.py's sched-lane arrivals (SCHED_RATE) and SLO mix
    (seed SLO_SEED), max_slots=4 and SchedulerConfig(slot_capacity=2.0,
    preempt=True) with variance claims.  Every query completes; one that retired on its own is
    within 3·ε of exact, a shed or deadline-stopped one within 3x its own
    error ratio; kernel 1 launches once per round; some round ran with a
    fairness weight below 1, and kernel 1 is checked on that round's
    inputs."""
    queries = deployment_queries(values)
    arrivals = [at for _, at in poisson_workload(
        queries, SCHED_RATE, seed=ARRIVAL_SEED)]
    cfg = EngineConfig(**ENGINE)
    t_full = float(store.num_tuples) / scan_tuples_per_s(store, cfg)
    slos = attach_slos(queries, t_full, seed=SLO_SEED)
    exact = exact_answers(values, queries)
    sched = WorkloadScheduler(SchedulerConfig(slot_capacity=SCHED_CAPACITY,
                                              preempt=True))
    with resident(store, packed):
        server = OLAWorkloadServer(store, cfg, options=ServerOptions(
            scheduler=sched, **SCHED_OPTIONS), device="cuda")
    try:
        for q, at, slo in zip(queries, arrivals, slos):
            server.submit(q, arrival_t=at, slo=slo)
        hooks = hook_timer(server, ("_apply_scheduling",
                                    "_admit_ready_scheduled"))
        contended = {"rounds": 0, "reorders": 0}
        order = sched.claim_order

        def claim_order(*args, **kw):
            out = order(*args, **kw)
            contended["reorders"] += out is not None
            return out

        sched.claim_order = claim_order

        def on_round(srv):
            contended["rounds"] += bool((srv._weights < 1).any())

        def below_one(*args, weights=None, **kw):
            return bool((weights < 1).any())

        reset_launches()
        t0 = time.perf_counter()
        with capture_kernel1(below_one) as kept:
            results = server.run(on_round=on_round)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        server.close()
    rounds = server.rounds
    if server.truncated or len(results) != len(queries):
        raise AssertionError("[sched] run truncated or a query never "
                             "completed")
    log(f"[sched] {'query':>16} {'priority':>11} {'outcome':>9} "
        f"{'slo_met':>7} {'wait':>9} {'rounds':>6} {'seen':>8} "
        f"{'dev/eps':>7} {'err':>7}")
    failures = []
    outcomes: dict[str, int] = {}
    for r, q in zip(results, queries):
        outcomes[r.sched_outcome] = outcomes.get(r.sched_outcome, 0) + 1
        ex = exact[q.name]
        dev = abs(r.estimate - ex) / abs(ex)
        on_its_own = (r.sched_outcome != "shed"
                      and (r.err <= q.epsilon or r.decision != -1))
        bound = 3 * q.epsilon if on_its_own else 3 * r.err
        if not (np.isfinite(r.estimate) and dev <= bound):
            failures.append(r.name)
        log(f"[sched] {r.name:>16} {r.priority:>11} {r.sched_outcome:>9} "
            f"{str(r.slo_met):>7} {r.queue_wait:9.5f} "
            f"{r.rounds_resident:6d} {r.tuples_seen:8d} "
            f"{dev / q.epsilon:7.3f} {r.err:7.4f}")
    launches = counts["slot_extract"]
    log(f"[sched] rounds {rounds}, tuples_scanned {server.tuples_scanned}, "
        f"outcomes {outcomes}, admission decisions "
        f"{sched.admission.decisions}, shed {server.shed_count}, preempted "
        f"{server.preempt_count}, rounds with a weight below 1: "
        f"{contended['rounds']}, claim tails reordered: "
        f"{contended['reorders']}; kernel 1 launches {launches}; wall "
        f"{wall:.3f} s, mean server round {wall / rounds * 1e3:.3f} ms, "
        f"scheduler hooks (_apply_scheduling + scheduled intake) "
        f"{hooks['s'] / rounds * 1e3:.4f} ms host per round; full-scan "
        f"time {t_full:.4f} modeled s")
    if failures:
        raise AssertionError(f"[sched] estimates outside their bounds: "
                             f"{failures}")
    if launches != rounds or sum(counts.values()) != launches:
        raise AssertionError(f"[sched] kernel 1 launches {launches} != "
                             f"rounds {rounds}, or another kernel ran: "
                             f"{counts}")
    if not contended["rounds"] or not kept:
        raise AssertionError("[sched] no round ran with a fairness weight "
                             "below 1")
    check = served_kernel_check(kept, "sched")
    return dict(rounds=rounds, launches=launches, wall_s=wall,
                hooks_s=hooks["s"], contended=contended["rounds"],
                reorders=contended["reorders"], outcomes=outcomes,
                check=check)


def build_queries(num_cols: int, count: int, seed: int) -> list[Query]:
    """bench_workload.py's cold queries."""
    rng = np.random.default_rng(seed)
    coeffs = tuple(1.0 / (k + 1) for k in range(num_cols))
    out = []
    for i in range(count):
        kind = rng.choice(["sum", "count", "avg"], p=[0.5, 0.3, 0.2])
        sel = float(rng.uniform(0.3, 1.0))
        pred = Range(0, 0.0, 1e8 * sel) if sel < 0.999 else TRUE
        eps = float(rng.uniform(0.04, 0.10))
        out.append(Query(agg=str(kind), expr=Linear(coeffs), pred=pred,
                         epsilon=eps, name=f"q{i}-{kind}"))
    return out


def build_hot_cold_mix(num_cols: int, n_hot: int, repeats: int,
                       n_cold: int, seed: int) -> list[Query]:
    """bench_workload.py's hot/cold mix: ``n_hot`` SUM patterns repeated
    ``repeats`` times (fresh Query objects), round-robin interleaved with
    ``n_cold`` cold queries."""
    coeffs = tuple(1.0 / (k + 1) for k in range(num_cols))
    rounds: list[list[Query]] = [[] for _ in range(repeats)]
    for h in range(n_hot):
        sel = 0.4 + 0.5 * (h / max(n_hot - 1, 1))
        for r in range(repeats):
            rounds[r].append(Query(
                agg="sum", expr=Linear(coeffs),
                pred=Range(0, 0.0, 1e8 * sel), epsilon=0.08,
                name=f"hot{h}-r{r}"))
    cold = build_queries(num_cols, n_cold, seed=seed + 1)
    for i, q in enumerate(cold):
        rounds[i % repeats].append(q)
    return [q for rnd in rounds for q in rnd]


def phase_rollup(store, values, packed) -> dict:
    """The hot/cold mix (bench_workload.py's rollup lane) on the packed
    deployment's table with max_slots=8 and RollupConfig(promote_hits=2):
    at least one tier-1 answer, every answer within 3·ε of exact, kernel 1
    launched once per round."""
    queries = build_hot_cold_mix(NUM_COLS, **ROLLUP_MIX)
    arrivals = [at for _, at in poisson_workload(
        queries, ROLLUP_RATE, seed=ROLLUP_ARRIVAL_SEED)]
    exact = exact_answers(values, queries)
    with resident(store, packed):
        server = OLAWorkloadServer(store, EngineConfig(**ENGINE),
                                   options=ServerOptions(
                                       rollup=RollupConfig(promote_hits=2),
                                       **ROLLUP_OPTIONS), device="cuda")
    try:
        for q, at in zip(queries, arrivals):
            server.submit(q, arrival_t=at)
        intake = hook_timer(server, ("_admit_ready",))
        reset_launches()
        t0 = time.perf_counter()
        results = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        server.close()
    rounds = server.rounds
    if server.truncated or len(results) != len(queries):
        raise AssertionError("[rollup] run truncated or a query never "
                             "completed")
    failures, tier1, worst = [], 0, 0.0
    for r, q in zip(results, queries):
        ex = exact[q.name]
        dev = abs(r.estimate - ex) / abs(ex)
        worst = max(worst, dev / q.epsilon)
        tier1 += r.sched_outcome == "tier1"
        if not (np.isfinite(r.estimate) and dev <= 3 * q.epsilon):
            failures.append(r.name)
    tier = server.rollup.counters()
    launches = counts["slot_extract"]
    log(f"[rollup] {len(queries)} queries: {tier1} answered tier-1, rounds "
        f"{rounds}, tuples_scanned {server.tuples_scanned}, tier counters "
        f"{tier}, worst |estimate - exact| {worst:.3f}·eps, kernel 1 "
        f"launches {launches}; wall {wall:.3f} s, mean server round "
        f"{wall / max(rounds, 1) * 1e3:.3f} ms, intake (tier-1 answers and "
        f"admission) {intake['s'] / max(rounds, 1) * 1e3:.4f} ms host per "
        f"round")
    if failures:
        raise AssertionError(f"[rollup] answers outside 3·eps: {failures}")
    if tier1 < 1:
        raise AssertionError("[rollup] no query was answered tier-1")
    if launches != rounds or sum(counts.values()) != launches:
        raise AssertionError(f"[rollup] kernel 1 launches {launches} != "
                             f"rounds {rounds}, or another kernel ran: "
                             f"{counts}")
    return dict(rounds=rounds, launches=launches, wall_s=wall, tier1=tier1,
                counters=tier, scanned=server.tuples_scanned)


# ------------------------------------------------------- grouped parity ----
GROUP_INT_FIELDS = ("cur", "head", "offset", "scan_m", "closed")


def trace_grouped(device) -> tuple[list, list, object]:
    """The grouped smoke lane on ``device``: per round the integer state
    (with stats.m and the cells' gm) and every slot's tracked values in
    promotion order; the results; the server."""
    values, _ = make_wiki_like(LANE["tuples"], num_languages=LANE["langs"],
                               seed=DATA_SEED)
    store = store_dataset(values, num_chunks=LANE["chunks"], fmt="ascii",
                          uneven=True, seed=DATA_SEED)
    server = OLAWorkloadServer(store, EngineConfig(**GROUP_ENGINE),
                               options=ServerOptions(**GROUP_OPTIONS),
                               device=device)
    for i, q in enumerate(grouped_queries(LANE["queries"])):
        server.submit(q, arrival_t=1e-4 * i)
    states = []

    def on_round(srv):
        st = srv.state
        rec = {f: getattr(st, f).cpu().numpy() for f in GROUP_INT_FIELDS}
        rec["stats.m"] = st.stats.m.cpu().numpy()
        rec["gm"] = st.gm.cpu().numpy()
        rec["promoted"] = [list(g) if g is not None else None
                           for g in srv._slot_groups]
        states.append(rec)

    results = server.run(on_round=on_round)
    return states, results, server


def phase_grouped_parity() -> int:
    """Card vs CPU on the grouped smoke lane: integer state, promotions in
    order and per-query rounds equal round for round; the cells' floats
    within a relative 1e-5 (float32 sums of the same terms in another
    order)."""
    on_card, res_card, _ = trace_grouped("cuda")
    on_cpu, res_cpu, _ = trace_grouped("cpu")
    if len(on_card) != len(on_cpu):
        raise AssertionError(f"grouped parity: rounds differ: card "
                             f"{len(on_card)}, cpu {len(on_cpu)}")
    for r, (a, b) in enumerate(zip(on_card, on_cpu)):
        for f in a:
            same = (a[f] == b[f]) if f == "promoted" else \
                np.array_equal(a[f], b[f])
            if not same:
                raise AssertionError(f"grouped parity round {r}: {f} differs "
                                     "card vs cpu")
    worst = 0.0
    for a, b in zip(res_card, res_cpu):
        if (a.name, a.rounds_resident, a.tuples_seen) != (
                b.name, b.rounds_resident, b.tuples_seen):
            raise AssertionError(f"grouped parity {a.name}: outcome differs")
        if [(g.value, g.n, g.is_other) for g in a.groups if not g.is_other] \
                != [(g.value, g.n, g.is_other) for g in b.groups
                    if not g.is_other]:
            raise AssertionError(f"grouped parity {a.name}: cells differ")
        for ga, gb in zip(a.groups, b.groups):
            d = abs(ga.estimate - gb.estimate) / max(abs(gb.estimate), 1e-30)
            worst = max(worst, d)
        log(f"[grouped-parity] {a.name:>8} rounds {a.rounds_resident:4d} seen "
            f"{a.tuples_seen:5d} tracked "
            f"{[g.value for g in a.groups if not g.is_other]}")
    if worst > 1e-5:
        raise AssertionError(f"grouped parity: cell estimates differ by "
                             f"{worst:.3g} relative card vs cpu")
    log(f"[grouped-parity] card == cpu over {len(on_card)} rounds: integer "
        f"state, gm and promotions identical; cell estimates within "
        f"{worst:.3g} relative")
    return len(on_card)


# --------------------------------------------------- grouped deployment ----
def exact_group_totals(values: np.ndarray, q: Query) -> np.ndarray:
    """Exact float64 per-language totals of a grouped SUM query."""
    col = next(k for k, c in enumerate(q.expr.coeffs) if c)
    return np.bincount(values[:, 0].astype(np.int64), weights=values[:, col],
                       minlength=GROUP_LANGS)


def run_grouped_server(store, device):
    server = OLAWorkloadServer(store, EngineConfig(**GROUP_ENGINE),
                               options=ServerOptions(**GROUP_OPTIONS),
                               device=device)
    for i, q in enumerate(grouped_queries()):
        server.submit(q, arrival_t=1e-4 * i)
    return server


def phase_grouped_deployment(values, store) -> dict:
    """The grouped deployment on the card (see GROUP_TUPLES): every query
    retires; top-5 recall against the exact per-language totals >= 0.9 on
    average (the lane's own gate); each query's five largest tracked cells
    within 3·ε of their exact totals, with __other__ non-empty; the grouped
    kernel launched once per round and no other kernel."""
    queries = grouped_queries()
    # earlier servers sit in reference cycles (metrics gauges close over
    # them) with their packed stores: collect them before the peak is reset
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    server = run_grouped_server(store, "cuda")
    fold = {"s": 0.0}
    fold_fn = server._fold_group_discovery

    def timed_fold(rep):
        t = time.perf_counter()
        fold_fn(rep)
        fold["s"] += time.perf_counter() - t

    server._fold_group_discovery = timed_fold
    reset_launches()
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    server.close()
    rounds = server.rounds
    if server.truncated or len(results) != len(queries):
        raise AssertionError("grouped deployment truncated")
    log(f"[grouped] {'query':>8} {'eps':>6} {'rounds':>6} {'seen':>7} "
        f"{'recall':>6} {'max dev/eps':>11} {'other n':>8}  tracked")
    failures, recalls = [], []
    for r, q in zip(results, queries):
        tot = exact_group_totals(values, q)
        true_top = set(np.argsort(-tot, kind="stable")[:GROUP_TOP_K]
                       .astype(float))
        groups = r.groups or []             # None: the query saw no tuple
        tracked = [g for g in groups if not g.is_other]
        other = [g for g in groups if g.is_other]
        recall = len(true_top & {g.value for g in tracked}) / GROUP_TOP_K
        recalls.append(recall)
        top = sorted(tracked, key=lambda g: -abs(g.estimate))[:GROUP_TOP_K]
        devs = [abs(g.estimate - tot[int(g.value)]) / abs(tot[int(g.value)])
                for g in top]
        worst = max(devs) / q.epsilon if devs else float("inf")
        if (len(top) < GROUP_TOP_K or worst > 3.0 or len(other) != 1
                or other[0].n <= 0):
            failures.append(r.name)
        log(f"[grouped] {r.name:>8} {q.epsilon:6.4f} {r.rounds_resident:6d} "
            f"{r.tuples_seen:7d} {recall:6.2f} {worst:11.3f} "
            f"{other[0].n if other else -1:8d}  "
            f"{[int(g.value) for g in tracked]}")
    mean_recall = float(np.mean(recalls))
    launches = counts["slot_extract_grouped"]
    log(f"[grouped] rounds {rounds}, tuples_scanned {server.tuples_scanned} "
        f"of {store.num_tuples}, top-up passes {server.topup_passes}, mean "
        f"top-{GROUP_TOP_K} recall {mean_recall:.3f}, grouped kernel "
        f"launches {launches}, wall {wall:.3f} s, mean server round "
        f"{wall / rounds * 1e3:.3f} ms, tally fold {fold['s'] / rounds * 1e3:.4f}"
        f" ms per round ({100 * fold['s'] / wall:.2f}% of the wall), peak "
        f"device memory {peak / 2**20:.1f} MiB (allocated before the run "
        f"{before / 2**20:.1f} MiB)")
    if failures:
        raise AssertionError(f"grouped cells outside 3·eps or empty spill: "
                             f"{failures}")
    if mean_recall < 0.9:
        raise AssertionError(f"grouped top-{GROUP_TOP_K} recall "
                             f"{mean_recall:.3f} < 0.9")
    if launches != rounds or sum(counts.values()) != launches:
        raise AssertionError(f"grouped kernel launches {launches} != rounds "
                             f"{rounds}, or another kernel ran: {counts}")
    return dict(rounds=rounds, launches=launches, wall_s=wall,
                fold_s=fold["s"], peak=peak, recall=mean_recall,
                packed=server.engine.packed,
                sizes=np.asarray(store.chunk_sizes))


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
    (all 128 decoded chunks, 512 MiB, fit), for its first CUT_ROUNDS
    rounds: every answer retired by then within 3·ε and, under the packed
    run's plans, it and the state at the cut bit for bit the packed run's
    at that round."""
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
            results = server.run(max_rounds=CUT_ROUNDS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            pf = eng.pipeline.counters()
            state = spmd_record(eng, server.state)
        finally:
            server.close()
        peak = torch.cuda.max_memory_allocated()
        with OLAWorkloadServer(disk, cfg, options=ServerOptions(**OPTIONS),
                               device="cuda") as again:
            for q, at in zip(queries, arrivals):
                again.submit(q, arrival_t=at)
            profile_rounds(again, PROFILE_ROUNDS, "stream")
    rounds = server.rounds
    if not server.truncated or rounds != CUT_ROUNDS:
        raise AssertionError(f"stream server ran {rounds} rounds, not cut "
                             f"at {CUT_ROUNDS}")
    cut = packed_run["cut"]
    if not cut:
        raise AssertionError(f"[stream] the packed run ended before round "
                             f"{CUT_ROUNDS}")
    packed_by_name = {p.name: p for p in packed_run["results"]}
    by_name = {q.name: q for q in queries}
    results = sorted(results, key=lambda r: r.qid)
    log(f"[stream] {'query':>16} {'plan':>14} {'estimate':>14} "
        f"{'dev/eps':>7} {'rounds':>6} {'seen':>8} | packed: {'plan':>14} "
        f"{'rounds':>6} {'seen':>8}")
    failures, same_plans = [], True
    for r in results:
        p, q = packed_by_name[r.name], by_name[r.name]
        ex = exact[q.name]
        dev = abs(r.estimate - ex) / abs(ex)
        if not (np.isfinite(r.estimate) and dev <= 3 * q.epsilon):
            failures.append(q.name)
        same_plans &= r.plan == p.plan
        log(f"[stream] {r.name:>16} {r.plan:>14} {r.estimate:14.7g} "
            f"{dev / q.epsilon:7.3f} {r.rounds_resident:6d} "
            f"{r.tuples_seen:8d} | packed: {p.plan:>14} "
            f"{p.rounds_resident:6d} {p.tuples_seen:8d}")
    log(f"[stream] rounds {rounds} (cut; the packed run "
        f"{packed_run['rounds']}), {len(results)} of {len(queries)} answers "
        f"retired; "
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
        same_results(result_rows(results), cut["results"], "[stream]")
        same_trace([state], [cut["state"]], "[stream]")
        log(f"[stream] every plan as in the packed run: the "
            f"{len(results)} answers retired by round {rounds} and the state "
            f"at the cut bit for bit the packed run's")
    else:
        log("[stream] plans differ from the packed run (the decoded cache "
            "prices a cached scan cheaper): outcomes reported above")
    return dict(rounds=rounds, modes=modes, launches=launches, peak=peak,
                wall_s=wall, feed_s=feed["s"], counters=pf)


# ------------------------------------------------------ rank-local widths ----
def width_rows(out, sel: slice) -> list:
    """The per-worker outputs of a kernel call cut to workers ``sel``."""
    out = out if isinstance(out, tuple) else (out,)
    return [t[sel] for t in out if t is not None]


def check_width(what: str, b: int, run, plain, full) -> dict:
    """One rank-width case: three launches with the same bits, every output
    row bit for bit the same worker's row of the W = 4 launch (``full``),
    and the stats within the phase-2 tolerance of the plain version."""
    got = same_bits(run, what)
    torch.cuda.synchronize()
    got_t = got if isinstance(got, tuple) else (got,)
    for g, f in zip([t for t in got_t if t is not None], full, strict=True):
        if not torch.equal(g.view(torch.int32), f.view(torch.int32)):
            raise AssertionError(f"{what}: a worker's rows differ from its "
                                 "rows of the W = 4 launch")
    rel = check_sums(got_t[0].cpu().numpy(), plain.cpu().numpy(), b, what)
    return dict(B=b, max_rel_err_sums=rel)


def phase_rank_widths(packed, sizes, lpacked, lsizes) -> list[dict]:
    """Kernels 1-4 at a rank's worker widths W = 1 and 2 (the [spmd]
    deployment runs kernel 1 at W = 2 on each rank): against the plain
    version, three launches the same bits, and each worker's rows equal to
    its rows of the W = 4 launch bit for bit.  The launch grid is
    (tiles(B), W), so a worker's blocks and fold order do not depend on
    W."""
    rng = np.random.default_rng(31)
    c = packed.shape[2] // FIELD_BYTES
    rows = []
    for b in EDGE_B:
        inputs = kernel_inputs(packed, sizes, b, rng)
        pk, jw, idx, b_eff, *plan = inputs
        coeffs, lo, hi, isc, gate, wts = plan
        slab, _, _, _, mb = stream_inputs(inputs)
        w4, r, rec = slab.shape
        dec = extract_parse_cuda(slab.reshape(w4 * r, rec), c).reshape(
            w4, r, c)
        base, groups, salt = grouped_case(lpacked, lsizes, b, rng, "main")
        gc_ = lpacked.shape[2] // FIELD_BYTES
        full = {
            "slot_extract": slot_extract_cuda(*inputs, return_cols=True),
            "slot_extract_stream": slot_extract_stream_cuda(
                slab, idx, b_eff, *plan, mb, cache_cap=CACHE_CAP),
            "slot_eval_decoded": slot_eval_decoded_cuda(
                dec, idx, b_eff, *plan, mb, cache_cap=CACHE_CAP),
            "slot_extract_grouped": slot_extract_grouped_cuda(
                *base, *groups, salt, kref.TALLY_BUCKETS, return_cols=True),
        }
        for w in (1, 2):
            for lo_w in range(0, 4, w):
                s = slice(lo_w, lo_w + w)
                cases = {
                    "slot_extract": (
                        lambda s=s: slot_extract_cuda(
                            pk, jw[s], idx[s], b_eff[s], *plan,
                            return_cols=True),
                        slot_extract_ref(pk, jw[s], idx[s], b_eff[s],
                                         coeffs, lo, hi, isc, gate,
                                         num_cols=c, weights=wts)[0]),
                    "slot_extract_stream": (
                        lambda s=s: slot_extract_stream_cuda(
                            slab[s], idx[s], b_eff[s], *plan, mb[s],
                            cache_cap=CACHE_CAP),
                        kref.slot_extract_stream_ref(
                            slab[s], idx[s], b_eff[s], coeffs, lo, hi, isc,
                            gate, num_cols=c, weights=wts)),
                    "slot_eval_decoded": (
                        lambda s=s: slot_eval_decoded_cuda(
                            dec[s], idx[s], b_eff[s], *plan, mb[s],
                            cache_cap=CACHE_CAP),
                        kref.slot_eval_decoded_ref(
                            dec[s], idx[s], b_eff[s], coeffs, lo, hi, isc,
                            gate, weights=wts)),
                    "slot_extract_grouped": (
                        lambda s=s: slot_extract_grouped_cuda(
                            base[0], base[1][s], base[2][s], base[3][s],
                            *base[4:], *groups, salt, kref.TALLY_BUCKETS,
                            return_cols=True),
                        kref.slot_extract_grouped_ref(
                            base[0], base[1][s], base[2][s], base[3][s],
                            *base[4:9], *groups, salt, num_cols=gc_,
                            return_cols=False, weights=base[9])[0]),
                }
                for name, (run, plain) in cases.items():
                    rows.append(dict(kernel=name, W=w, **check_width(
                        f"{name} W={w} workers {lo_w}.. B={b}", b, run,
                        plain, width_rows(full[name], s))))
        log(f"[rank-width] B={b}: kernels 1-4 at W = 1 and 2 against their "
            f"plain versions (sums max rel err "
            f"{max(x['max_rel_err_sums'] for x in rows if x['B'] == b):.3g}),"
            f" 3 launches the same bits, every worker's rows == its rows of "
            f"the W = 4 launch, bit for bit")
    return rows


# ---------------------------------------------------------------- spmd ----
# the multi-rank phases: each rank a spawned process on the one card; a
# rank count of 1 runs NCCL, more share the card over gloo (NCCL refuses
# two ranks on one device)
SPMD_RANKS = (1, 2, 4)
SPMD_JOIN_S = 600.0           # a rank group's time limit
SPMD_PG_TIMEOUT_S = 120
SPMD_WORKERS = 8
COEF8 = tuple(1.0 / (k + 1) for k in range(8))


def spmd_mesh(ranks: int, rank: int, init_file: str, device: str):
    """Join the rank group and return its one-dimensional ``data`` mesh."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    backend = "nccl" if device == "cuda" and ranks == 1 else "gloo"
    # the ranks share the host's cores: an intra-op pool of every core per
    # rank oversubscribes them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=ranks,
        timeout=datetime.timedelta(seconds=SPMD_PG_TIMEOUT_S))
    return init_device_mesh(device, (ranks,), mesh_dim_names=("data",))


def spmd_record(eng, state, rep=None, grouped=False) -> dict:
    """A round's state on the host: ``cur`` gathered over the ranks, the
    integer and float state, the statistics, the estimates."""
    rec = {f: getattr(state, f).cpu().numpy() for f in (
        "head", "scan_m", "offset", "closed", "raw_touched", "budget",
        "t_io", "t_cpu", "calib_sum", "calib_cnt", "cache", "schedule",
        "stopped")}
    rec["cur"] = eng.coll.gather_workers(state.cur).cpu().numpy()
    for f in ("m", "ysum", "ysq", "psum"):
        rec["stats." + f] = getattr(state.stats, f).cpu().numpy()
    if grouped:
        for f in ("gm", "gys", "gyq", "gps"):
            rec[f] = getattr(state, f).cpu().numpy()
    if rep is not None:
        for f in ("estimate", "lo", "hi", "err", "bytes_round"):
            rec[f] = getattr(rep, f).cpu().numpy()
        if grouped:
            for f in ("g_est", "g_err", "g_n", "g_tal"):
                rec[f] = getattr(rep, f).cpu().numpy()
    return rec


def spmd_slot_queries():
    return [Query(agg="sum", expr=Linear(COEF8), pred=Range(0, 0.0, 6e7),
                  epsilon=0.04, name="s"),
            Query(agg="count", pred=Range(1, 0.0, 7e7), epsilon=0.06,
                  name="c"),
            Query(agg="avg", expr=Linear(COEF8), epsilon=0.05, name="a")]


def spmd_drives(device: str, mesh=None) -> dict:
    """tests/test_engine_spmd.py's drives on ``device``, single-device
    (``mesh`` None) or over the mesh's ranks: the state after every round
    (and the served results).  frozen: 4,096 tuples, 8 columns, 16 uneven
    ASCII chunks, single-pass, a 32-row synopsis cache; slot: 2,048
    tuples, 12 chunks, a third query admitted at round 3, and the same
    drive streamed (and with a two-chunk decoded cache); grouped: 2,048
    wiki-like tuples, 8 chunks, max_groups=4; server: max_slots=4 with a
    synopsis.  num_workers=8 split over the ranks."""
    from repro_torch.core.engine import OLAEngine
    from repro_torch.core.engine_spmd import SlotSPMDEngine, SPMDEngine

    def slot_engine(store, s, cfg):
        return (SlotOLAEngine(store, s, cfg, device=device) if mesh is None
                else SlotSPMDEngine(store, s, cfg, mesh, device=device))

    zipf = make_synthetic_zipf(2048, 8, seed=3)
    store = store_dataset(zipf, 12, "ascii", uneven=True)
    out = {}

    def slot_drive(cfg):
        eng = slot_engine(store, 4, cfg)
        q0, q1, q2 = spmd_slot_queries()
        table = empty_slot_table(4, 8, device=device)
        for s, q in ((0, q0), (1, q1)):
            table = slot_table_set(table, s, encode_slot(q, 8,
                                                         plan="single_pass"))
        trace = []
        try:
            state = eng.init_state()
            for r in range(24):
                if r == 3:
                    table = slot_table_set(table, 2, encode_slot(
                        q2, 8, plan="single_pass"))
                b = eng.budget_ladder(float(state.budget))
                state, data = eng.round_data(state)
                mode, data = eng.data_mode(data)
                state, rep = eng.round_fn(b, mode)(state, table, data,
                                                   eng.speeds)
                trace.append(spmd_record(eng, state, rep))
        finally:
            eng.close()
        return dict(trace=trace)

    slot_cfg = dict(num_workers=SPMD_WORKERS, budget_init=32, budget_min=32,
                    budget_max=32, seed=5, cache_cap=16)
    out["slot"] = slot_drive(EngineConfig(**slot_cfg))
    out["stream"] = slot_drive(EngineConfig(residency="stream", **slot_cfg))
    block = store.max_chunk_tuples * store.codec.num_cols * 4
    out["stream, 2-chunk cache"] = slot_drive(EngineConfig(
        residency="stream", decoded_cache_bytes=2 * block, **slot_cfg))

    fstore = store_dataset(make_synthetic_zipf(4096, 8, seed=3), 16,
                           "ascii", uneven=True)
    fq = Query(agg="sum", expr=Linear(COEF8), pred=Range(0, 0.0, 0.5e8),
               epsilon=0.05)
    fcfg = EngineConfig(num_workers=SPMD_WORKERS, strategy="single_pass",
                        budget_init=64, seed=5, cache_cap=32)
    eng = (OLAEngine(fstore, [fq], fcfg, device=device) if mesh is None
           else SPMDEngine(fstore, [fq], fcfg, mesh, device=device))
    state, trace = eng.init_state(), []
    for _ in range(300):
        b = eng.budget_ladder(float(state.budget))
        state, data = eng.round_data(state)
        state, rep = eng.round_fn(b)(state, data, eng.speeds)
        trace.append(spmd_record(eng, state, rep))
        if bool(rep.all_stopped) or bool(rep.exhausted):
            break
    out["frozen"] = dict(trace=trace)

    wv, _ = make_wiki_like(2048, num_languages=12, seed=7)
    gstore = store_dataset(wv, 8, "ascii", uneven=True)
    gcfg = EngineConfig(max_groups=4, **slot_cfg)
    qg = Query(agg="sum", expr=Linear((0.0, 1.0, 0.0, 0.0)), epsilon=0.03,
               group_by=GroupBy(col=0, max_groups=4, top_k=2,
                                values=[0.0, 1.0, 2.0]))
    qd = Query(agg="count", pred=Range(3, 0.0, 400.5), epsilon=0.05,
               group_by=GroupBy(col=0, max_groups=4, top_k=2))
    eng = slot_engine(gstore, 2, gcfg)
    table = empty_slot_table(2, 4, 4, device=device)
    for s, q in ((0, qg), (1, qd)):
        table = slot_table_set(table, s, encode_slot(
            q, 4, plan="single_pass", max_groups=4))
    state, trace = eng.init_state(), []
    for _ in range(10):
        b = eng.budget_ladder(float(state.budget))
        state, data = eng.round_data(state)
        state, rep = eng.round_fn(b)(state, table, data, eng.speeds)
        trace.append(spmd_record(eng, state, rep, grouped=True))
    out["grouped"] = dict(trace=trace)

    trace = []
    with OLAWorkloadServer(store, EngineConfig(num_workers=SPMD_WORKERS,
                                               seed=5),
                           options=ServerOptions(
                               max_slots=4, synopsis_budget_tuples=512,
                               mesh=mesh), device=device) as srv:
        q0, q1, q2 = spmd_slot_queries()
        for q, at in ((q0, 0.0), (q1, 0.0), (q2, 2e-4)):
            srv.submit(q, arrival_t=at)
        srv.run(on_round=lambda s: trace.append(spmd_record(s.engine,
                                                            s.state)))
        out["server"] = dict(trace=trace, rounds=srv.rounds, results=[
            tuple(getattr(r, f) for f in RESULT_INTS + RESULT_FLOATS)
            for r in sorted(srv.results, key=lambda r: r.qid)])
    return out


def spmd_sched_runs(device: str, mesh=None) -> dict:
    """[sched-parity]'s scheduled workload (the small example table with
    SLOs, max_slots=2, num_workers=4) under NEUTRAL and under
    SchedulerConfig(slot_capacity=1.0, preempt=True) with variance claims,
    single-device or over the mesh's ranks."""
    values = make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)
    store = store_dataset(values, num_chunks=64, fmt="ascii")
    work = [[(q, at, slo, None)
             for q, at, slo in parity_slo_workload(values)]]
    scheds = {"neutral": lambda: WorkloadScheduler(NEUTRAL),
              "variance": lambda: WorkloadScheduler(SchedulerConfig(
                  slot_capacity=1.0, preempt=True,
                  claim_policy="variance"))}
    out = {}
    for name, make in scheds.items():
        run = serve_traced(store, device, make(), work, floats=True,
                           mesh=mesh)
        out[name] = {k: run[k] for k in ("trace", "rounds")}
        out[name]["results"] = run["results"]
    return out


def spmd_parity_rank(rank: int, ranks: int, init_file: str, out_dir: str,
                     device: str) -> None:
    """One rank of [spmd-parity]: every drive over the mesh, launches
    counted per kernel, results to ``out_dir/rank<r>.pkl``."""
    import pickle

    import torch.distributed as dist

    mesh = spmd_mesh(ranks, rank, init_file, device)
    try:
        reset_launches()
        out = spmd_drives(device, mesh)
        if ranks == 2:
            out["sched"] = spmd_sched_runs(device, mesh)
        out["launches"] = launch_counts()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, ranks: int, args: tuple, tag: str) -> list:
    """Run ``fn(rank, ranks, init_file, out_dir, *args)`` on ``ranks``
    spawned processes, joined within SPMD_JOIN_S (every one killed past
    it); each rank's pickled result."""
    import pickle

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spmd_") as tmp:
        ctx = mp.start_processes(
            fn, args=(ranks, os.path.join(tmp, "pg"), tmp, *args),
            nprocs=ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + SPMD_JOIN_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{tag}: {ranks} ranks did not "
                                         f"finish in {SPMD_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def same_trace(got: list, want: list, what: str) -> None:
    """Round-for-round equality of two state traces, bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rounds, single device "
                             f"{len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        for f in w:
            a, b = np.asarray(g[f]), np.asarray(w[f])
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"{what}: round {r}: {f} differs")


def result_rows(results) -> list:
    """Retired queries' integer and float fields, by query id."""
    return [tuple(getattr(r, f) for f in RESULT_INTS + RESULT_FLOATS)
            for r in sorted(results, key=lambda r: r.qid)]


def same_results(got: list, want: list, what: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, single device "
                             f"{len(want)}")
    for g, w in zip(got, want):
        for u, v in zip(g, w):
            if not (u == v or (u != u and v != v)):
                raise AssertionError(f"{what}: {w[1]}: {g} != {w}")


def phase_spmd_parity(device: str = "cuda") -> dict:
    """Every drive of :func:`spmd_drives` over 1 (NCCL), 2 and 4 (gloo)
    ranks on the card against the single-device card run, bit for bit,
    round for round, on every rank; under 2 ranks also the scheduled
    workload (NEUTRAL and variance claims).  Kernels 1-5 launched on every
    rank."""
    t0 = time.perf_counter()
    single = spmd_drives(device)
    sched = spmd_sched_runs(device)
    log(f"[spmd-parity] single-device drives on the card in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{k} {len(v['trace'])} rounds" for k, v in single.items()))
    secs = {}
    for ranks in SPMD_RANKS:
        t0 = time.perf_counter()
        outs = spawn_ranks(spmd_parity_rank, ranks, (device,),
                           "[spmd-parity]")
        secs[ranks] = time.perf_counter() - t0
        for rank, out in enumerate(outs):
            where = f"[spmd-parity] D={ranks} rank {rank}"
            for name, want in single.items():
                same_trace(out[name]["trace"], want["trace"],
                           f"{where} {name}")
                if "results" in want:
                    same_results(out[name]["results"], want["results"],
                                 f"{where} {name}")
            if ranks == 2:
                for name, want in sched.items():
                    same_trace(out["sched"][name]["trace"], want["trace"],
                               f"{where} sched {name}")
                    bitwise_equal(out["sched"][name], want,
                                  f"{where} sched {name}")
            idle = [k for k in ("slot_extract", "slot_extract_stream",
                                "slot_eval_decoded", "slot_extract_grouped",
                                "extract_parse")
                    if out["launches"][k] == 0]
            if idle and device == "cuda":
                raise AssertionError(f"{where}: kernels never launched: "
                                     f"{idle}")
        log(f"[spmd-parity] D={ranks} ({'NCCL' if ranks == 1 else 'gloo'}, "
            f"{SPMD_WORKERS // ranks} workers a rank): every drive's state, "
            f"every round, and the server's results bit for bit the "
            f"single-device card run's on all {ranks} rank(s)"
            + ("; the scheduled workload too, NEUTRAL "
               f"({sched['neutral']['rounds']} rounds) and variance "
               f"({sched['variance']['rounds']} rounds)"
               if ranks == 2 else "")
            + f"; launches on rank 0 {outs[0]['launches']}; "
            f"{secs[ranks]:.1f} s with the spawn")
    return secs


def spmd_deployment_rank(rank: int, ranks: int, init_file: str,
                         out_dir: str, store_dir: str, thr: float, arrivals,
                         device: str) -> None:
    """One rank of [spmd]: the packed deployment's first CUT_ROUNDS
    rounds served over the mesh; the first PROFILE_ROUNDS under the
    profiler (device idle share), the rest timed; the state at the cut,
    collective seconds, launches and peak memory."""
    import pickle

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    mesh = spmd_mesh(ranks, rank, init_file, device)
    card = device == "cuda"
    try:
        store = ChunkStore.open(store_dir, "deployment")
        if card:
            torch.cuda.reset_peak_memory_stats()
        server = OLAWorkloadServer(store, EngineConfig(**ENGINE),
                                   options=ServerOptions(mesh=mesh,
                                                         **OPTIONS),
                                   device=device)
        queries = deployment_query_list(NUM_COLS, thr)
        for q, at in zip(queries, arrivals):
            server.submit(q, arrival_t=at)
        coll = server.engine.coll
        reduce_ = coll._all_reduce
        spent = {"s": 0.0, "n": 0}

        def timed(t, op=None):
            t1 = time.perf_counter()
            out = reduce_(t, op)
            spent["s"] += time.perf_counter() - t1
            spent["n"] += 1
            return out

        coll._all_reduce = timed
        sync = torch.cuda.synchronize if card else (lambda: None)
        reset_launches()
        sync()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if card else [])) as prof:
            server.run(max_rounds=PROFILE_ROUNDS)
            sync()
        prof_wall = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        first = server.rounds
        spent.update(s=0.0, n=0)
        t0 = time.perf_counter()
        results = server.run(max_rounds=CUT_ROUNDS)
        sync()
        wall = time.perf_counter() - t0
        out = dict(
            rounds=server.rounds, truncated=server.truncated,
            launches=launch_counts(), wall_s=wall, timed_rounds=(
                server.rounds - first), coll_s=spent["s"],
            collectives=spent["n"], idle=1.0 - busy / (prof_wall * 1e6),
            peak=torch.cuda.max_memory_allocated() if card else 0,
            results=result_rows(results),
            state=spmd_record(server.engine, server.state))
        server.close()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_spmd(store, values, packed_run: dict, card: str,
               device: str = "cuda") -> dict:
    """The packed deployment's first CUT_ROUNDS rounds served with
    ServerOptions(mesh=...) over 2 gloo ranks x 2 workers on the one card,
    each rank holding its own copy of the 2 GiB store: the state after the
    cut and every answer retired by then bit for bit the single-device
    run's at that round, kernel 1 launches == rounds on each rank (at
    W = 2)."""
    queries = deployment_queries(values)
    arrivals = [at for _, at in poisson_workload(
        queries, ARRIVALS_PER_MODEL_S, seed=ARRIVAL_SEED)]
    ranks = 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        t0 = time.perf_counter()
        write_disk_store(store, tmp)
        log(f"[spmd] the deployment's chunks written for the ranks in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        thr = queries[2].having.threshold
        outs = spawn_ranks(spmd_deployment_rank, ranks,
                           (tmp, thr, arrivals, device), "[spmd]")
        secs = time.perf_counter() - t0
    cut = packed_run["cut"]
    if not cut:
        raise AssertionError(f"[spmd] the single-device run ended before "
                             f"round {CUT_ROUNDS}")
    single_ms = packed_run["wall_s"] / packed_run["rounds"] * 1e3
    for rank, o in enumerate(outs):
        where = f"[spmd] rank {rank}"
        if not o["truncated"] or o["rounds"] != CUT_ROUNDS:
            raise AssertionError(f"{where}: {o['rounds']} rounds, not cut "
                                 f"at {CUT_ROUNDS}")
        same_results(o["results"], cut["results"], where)
        same_trace([o["state"]], [cut["state"]], where)
        if device == "cuda" and (o["launches"]["slot_extract"] != o["rounds"]
                                 or sum(o["launches"].values())
                                 != o["rounds"]):
            raise AssertionError(f"{where}: launches {o['launches']} != "
                                 f"rounds {o['rounds']}")
        log(f"[spmd] {card}: rank {rank} of {ranks} (gloo, "
            f"{ENGINE['num_workers'] // ranks} workers): {o['rounds']} "
            f"rounds (of {packed_run['rounds']}), the state at the cut and "
            f"the {len(o['results'])} answers retired by then bit for bit "
            f"the single-device run's, "
            f"kernel 1 launches {o['launches']['slot_extract']} at W = "
            f"{ENGINE['num_workers'] // ranks}; "
            f"{o['wall_s'] / o['timed_rounds'] * 1e3:.3f} ms per round "
            f"(after the {PROFILE_ROUNDS} profiled; single device "
            f"{single_ms:.3f}), collectives "
            f"{o['coll_s'] / o['timed_rounds'] * 1e3:.3f} ms per round "
            f"({o['collectives'] / o['timed_rounds']:.2f} a round); device "
            f"idle {100 * o['idle']:.1f}% of the first {PROFILE_ROUNDS} "
            f"rounds; peak device memory {o['peak'] / 2**20:.1f} MiB")
    log(f"[spmd] {secs:.1f} s with the spawn")
    return dict(ranks=outs, seconds=secs)


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
    """(mean device ms per call of the kernels whose name contains one of
    ``match``, device kernels per call) from a ``torch.profiler`` (CUPTI)
    trace of ``iters`` calls; (None, None) when the trace holds no device
    time for them.  The count takes every device activity of the trace
    (kernels, copies, fills): the calls are all the trace runs."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0]
    us = sum(e.self_device_time_total for e in on_device
             if any(m in e.key for m in match))
    if us <= 0:
        return None, None
    return us / 1e3 / iters, sum(e.count for e in on_device) / iters


def one_launch(name: str, per_call) -> None:
    """A redesigned kernel must run one device kernel per call."""
    if name in ONE_LAUNCH and per_call is not None and per_call != 1:
        raise AssertionError(f"{name}: {per_call} device kernels per call, "
                             "expected 1")


def timed_calls(name: str, fn, iters: int, match: tuple) -> dict:
    """Device ms per call and device kernels per call (profiler), and the
    wall per call with the wrapper's host work (CUDA events).  A trace with
    no device time for the kernel, or a count of device activities that is
    not a whole multiple of the calls, lost events (seen: 199 activities in
    200 calls of a one-kernel call, and a trace of extract_parse with
    none): the calls are traced again, up to three times, and every lost
    trace is logged."""
    for attempt in range(3):
        ms, per_call = device_ms(fn, iters, match)
        if per_call is not None and per_call == round(per_call):
            break
        log(f"[times] {name}: trace {attempt + 1} lost events "
            f"({per_call} device activities per call); tracing again")
    one_launch(name, per_call)
    return dict(device_ms=ms, kernels_per_call=per_call,
                call_ms=time_cuda(fn, iters))


def phase_times(packed: torch.Tensor, sizes: np.ndarray, rungs: list,
                wall_s: float | None) -> dict:
    rng = np.random.default_rng(5)
    c = packed.shape[2] // FIELD_BYTES
    per_rung, per_call, sets, kernels = {}, {}, {}, {}
    for b in sorted(set(rungs) | {8, 4096}):
        # 16 input sets over distinct chunks, cycled, so a launch does not
        # find its window rows in L2 from the launch before
        sets[b] = []
        for _ in range(16):
            inp = list(kernel_inputs(packed, sizes, b, rng))
            inp[3] = torch.full_like(inp[3], b)      # full budgets
            sets[b].append(inp)

        def call(i, b=b):
            return slot_extract_cuda(*sets[b][i % 16], return_cols=True)

        # device time of the kernel and the device kernels per call, and
        # the wall per call with the wrapper's host work (checks,
        # allocation, ctypes) included
        t = timed_calls("slot_extract", call, 200, ("slot_extract_tiles",))
        per_rung[b], kernels[b], per_call[b] = (
            t["device_ms"], t["kernels_per_call"], t["call_ms"])

    def plain(i):
        (p, jw, idx, be, co, lo, hi, isc, gate, wts) = sets[4096][i % 16]
        return slot_extract_ref(p, jw, idx, be, co, lo, hi, isc, gate,
                                num_cols=c, return_cols=True, weights=wts)

    plain_ms = time_cuda(plain, 20)
    bound_ms, bound_by = kernel_bound_ms(4, 4096, c, 8, True)
    out = dict(ms=per_rung[4096], call_ms=per_call, device_ms=per_rung,
               kernels_per_call=kernels, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               bounds={b: kernel_bound_ms(4, b, c, 8, True)[0]
                       for b in per_rung},
               round_ms=None, kernel_share=None)
    if wall_s is not None:
        out["round_ms"] = wall_s / len(rungs) * 1e3
        if all(per_rung[b] is not None for b in rungs):
            out["kernel_share"] = sum(per_rung[b] for b in rungs) / 1e3 / wall_s
    return out


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


# window widths of the slab kernels' times: the packed kernel's rungs
STREAM_TIME_B = (8, 16, 32, 64, 4096)


def phase_stream_times(packed: torch.Tensor, sizes: np.ndarray) -> dict:
    """Device and per-call times of the three slab-path kernels at the main
    path's shapes, their bounds and their plain versions' times."""
    rng = np.random.default_rng(17)
    n, m_max, rec = packed.shape
    c = rec // FIELD_BYTES
    out = {}
    for b in STREAM_TIME_B:
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

        match = ("slab_tiles",)
        out[("slot_extract_stream", b)] = timed_calls(
            "slot_extract_stream", raw, 200, match)
        out[("slot_eval_decoded", b)] = timed_calls(
            "slot_eval_decoded", decoded, 200, match)
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
        **timed_calls("extract_parse", parse, 100, ("parse_rows",)),
        plain_ms=time_cuda(lambda i: kref.parse_ascii_ref(chunks[i % 16], c),
                           10),
        bound=bound(t * rec + t * c * 4, t * c * (14 * 2 + 3)))
    return out


def grouped_bound_ms(w: int, b: int, c: int, s: int, g: int, h: int,
                     return_cols: bool):
    """The grouped kernel's bound: window rows, indices, budgets, plan and
    group descriptors read once; stats, cells, tallies (and cols) written
    once; per row the parse and per slot the evaluation, per cell the
    indicator and its four terms, per slot the hash and three moments."""
    nbytes = (w * b * c * FIELD_BYTES + w * b * 4 + 2 * w * 4
              + 3 * s * c * 4 + 3 * s * 4 + s * 4 + 2 * s * g * 4 + 4
              + w * s * 4 * 4 + w * s * g * 4 * 4 + w * s * 3 * h * 4
              + (w * b * c * 4 if return_cols else 0))
    ops_ = w * b * (c * (14 * 2 + 3) + s * (2 * c + 2 * c + 8) + s * g * 8
                    + s * 9)
    return bound(nbytes, ops_)


def rows_bound_ms(rows: int, blocks: int, c: int, q: int):
    """A rows pass's bound: the valid rows read once, the valid counts and
    plan read, (blocks, Q, 4) written; per row the parse and per plan 2C
    compares, C multiply-adds and 8 ops."""
    nbytes = (rows * c * FIELD_BYTES + blocks * 4 + 3 * q * c * 4
              + blocks * q * 16)
    return bound(nbytes, rows * (c * (14 * 2 + 3) + q * (4 * c + 8)))


def phase_grouped_times(gpacked, gsizes, packed, sizes, rows: dict) -> dict:
    """Device and per-call times of the three kernels this slice added, at
    the main path's shapes, beside their bounds and plain versions."""
    rng = np.random.default_rng(37)
    out = {}
    c = gpacked.shape[2] // FIELD_BYTES
    h = kref.TALLY_BUCKETS
    for b in (8, 4096):
        sets = []
        for _ in range(16):
            base, groups, salt = grouped_case(gpacked, gsizes, b, rng,
                                              "deployment")
            base[3] = torch.minimum(torch.full_like(base[3], b),
                                    torch.as_tensor(gsizes, device="cuda")
                                    [base[1].long()].to(torch.int32))
            sets.append((base, groups, salt))

        def call(i, sets=sets):
            base, groups, salt = sets[i % 16]
            return slot_extract_grouped_cuda(*base, *groups, salt, h)

        rows_read = int(sets[0][0][3].sum())
        v = dict(**timed_calls("slot_extract_grouped", call, 200,
                               ("grouped_tiles",)),
                 bound=grouped_bound_ms(4, b, c, 4, 9, h, False),
                 rows=rows_read)
        if b == 4096:
            def plain(i, sets=sets):
                base, groups, salt = sets[i % 16]
                return kref.slot_extract_grouped_ref(
                    *base[:9], *groups, salt, num_cols=c, weights=base[9])
            v["plain_ms"] = time_cuda(plain, 20)
        out[("slot_extract_grouped", b)] = v
    n, m_max, rec = packed.shape
    cc = rec // FIELD_BYTES
    plan, sizes_t = rows["plan"], rows["sizes_t"]
    q = plan[0].shape[0]

    def agg(i):
        return chunk_agg_cuda(packed, sizes_t, *plan)

    plain_chunk_agg(packed, sizes_t, plan)            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain_chunk_agg(packed, sizes_t, plan)
    end.record()
    torch.cuda.synchronize()
    out[("chunk_agg", n)] = dict(
        **timed_calls("chunk_agg", agg, 20, ("chunk_agg_rows",)),
        plain_ms=start.elapsed_time(end),
        bound=rows_bound_ms(int(sizes.sum()), n, cc, q))
    sets = []
    for _ in range(16):
        jw, idx, _ = round_window(packed, sizes, 4096, rng)
        slab = packed[jw.long()[:, None], idx.long()].contiguous()
        sets.append((slab, torch.full((4,), 4096, dtype=torch.int32,
                                      device="cuda")))

    def rs(i):
        slab, be = sets[i % 16]
        return round_stats_cuda(slab, be, *plan)

    def prs(i):
        slab, be = sets[i % 16]
        return kref.round_stats_ref(slab, cc, *plan, be)

    out[("round_stats", 4096)] = dict(
        **timed_calls("round_stats", rs, 200, ("round_stats_rows",)),
        plain_ms=time_cuda(prs, 20),
        bound=rows_bound_ms(4 * 4096, 4, cc, q))
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
    t1 = time.perf_counter()
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
        f"wall); the profiler's processing took "
        f"{time.perf_counter() - t1:.1f} s")
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


def us(t) -> str:
    """ms as µs for a log line, or "not measured"."""
    return "not measured" if t is None else f"{t * 1e3:.2f}"


def measured(device: float | None, call: float) -> dict:
    """A kernel's ms for the result line: its device time from the
    profiler, or, where the profiler saw none, the wall per call from
    CUDA events, named as such."""
    if device is not None:
        return {"ms": device, "ms_source": "device (profiler)"}
    return {"ms": call, "ms_source": "wall per call (CUDA events)"}


def report_times(card: str, times: dict, stimes: dict, gtimes: dict,
                 dep: dict | None, gdep: dict | None) -> None:
    """Log every kernel's times beside its bound, its plain version, the
    device kernels per call and its launches per deployment round (None:
    the deployments did not run)."""
    def kernels(v) -> str:
        k = v.get("kernels_per_call")
        return ("device kernels per call not measured" if k is None
                else f"{k:g} device kernel(s) per call")

    log(f"[times] {card}: slot_extract at W=4 B=4096 C=16 S=8 with cols: "
        f"{us(times['device_ms'][4096])} us device time per launch "
        f"(profiler); {us(times['call_ms'][4096])} us per call with the "
        f"wrapper's host work (CUDA events); bound "
        f"{times['bound_ms'] * 1e3:.3f} us ({times['bound_by']}); plain "
        f"version {times['plain_ms'] * 1e3:.1f} us")
    log(f"[times] {card}: slot_extract device us per launch by B: "
        + ", ".join(f"B={b}: {us(t)} (bound {times['bounds'][b] * 1e3:.3f})"
                    for b, t in times["device_ms"].items()))
    log(f"[times] {card}: slot_extract us per call by B: "
        + ", ".join(f"B={b}: {us(t)}" for b, t in times["call_ms"].items()))
    log(f"[times] {card}: slot_extract device kernels per call by B: "
        + ", ".join(f"B={b}: {'not measured' if k is None else f'{k:g}'}"
                    for b, k in times["kernels_per_call"].items()))
    if times["round_ms"] is not None:
        share = ("not measured" if times["kernel_share"] is None
                 else f"{100 * times['kernel_share']:.3f}%")
        log(f"[times] {card}: server mean round {times['round_ms']:.3f} ms; "
            f"kernel share of round time {share} (device time per B x "
            f"rounds at each B / server wall)")
    for (name, b), v in stimes.items():
        shape = (f"T={b} rows" if name == "extract_parse"
                 else f"W=4 B={b} C=16 S=8 cap={CACHE_CAP}")
        plain = v.get("plain_ms")
        per_round = ("" if dep is None else
                     f"; {dep['launches'][name] / dep['rounds']:.4f} launches"
                     " per stream-deployment round")
        log(f"[times] {card}: {name} at {shape}: {us(v['device_ms'])} us "
            f"device time per launch (profiler), {kernels(v)}; "
            f"{us(v['call_ms'])} us per call with the wrapper (CUDA events); "
            f"bound {v['bound'][0] * 1e3:.3f} us ({v['bound'][1]}); plain "
            f"version {us(plain)}{'' if plain is None else ' us'}"
            f"{per_round}")
    for (name, b), v in gtimes.items():
        shape = {"slot_extract_grouped": f"W=4 B={b} C=4 S=4 G=9 H=128",
                 "chunk_agg": f"N={b} chunks, C=16 Q=8",
                 "round_stats": f"W=4 B={b} C=16 Q=8"}[name]
        plain = v.get("plain_ms")
        per_round = ""
        if gdep is not None:
            n = gdep["launches"] if name == "slot_extract_grouped" else 0
            per_round = (f"; {n / gdep['rounds']:.4f} launches per "
                         "grouped-deployment round")
        log(f"[times] {card}: {name} at {shape}: {us(v['device_ms'])} us "
            f"device time per launch (profiler), {kernels(v)}; "
            f"{us(v['call_ms'])} us per call with the wrapper (CUDA events); "
            f"bound {v['bound'][0] * 1e3:.3f} us ({v['bound'][1]}); plain "
            f"version {us(plain)}{'' if plain is None else ' us'}"
            f"{per_round}")


# ------------------------------------------------------------ ML plane ----
# The ML plane's serving path: the dense DecoderLM at
# qwen3-0.6b's published widths (28 layers, d_model 1024, 16 Q / 8 KV heads
# of 128, SwiGLU 3072, vocab 151,936 padded to 152,064, tied), random
# weights from ML_SEED on the card's generator.
ML_ARCH = "qwen3-0.6b"
ML_SEED = 0
PARITY_LAYERS = 4            # the card-vs-CPU checks' depth, full widths
# decode token by token against forward, bf16 compute over 28 layers: the
# two paths round their bf16 products in other shapes, so the logits may
# differ by a few bf16 ulps of the largest logit (one ulp = 2^-7 of it)
DECODE_TOL = 2.0 ** -4
# card against CPU at float32 compute (TF32 off): the products sum in
# other orders on the two devices
F32_TOL = 1e-4
PREFILL_SHAPE = (4, 512)
SERVE = dict(requests=6, slots=3, prompt=8, max_new=12, max_len=512)
OLA_EVAL = dict(epsilon=0.02, batch=32, seed=1)
CORPUS = dict(vocab=151936, num_segments=8, docs_per_segment=512,
              doc_len=256, poison_every=3, seed=0)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_mib(device):
    """Peak device memory since the last reset, MiB (None off the card)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**20


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def step_mark(device):
    """Before a step: (bytes allocated, the peak since the last reset),
    then the peak reset; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    mark = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return mark


def step_high(device, mark):
    """After a step: its own high-water mark in bytes above what was
    allocated at ``mark`` (None off the card)."""
    if mark is None:
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - mark[0]


def ml_config(layers: int | None = None, dtype: str | None = None):
    cfg = get_config(ML_ARCH)
    kw = {}
    if layers is not None:
        kw["num_layers"] = layers
    if dtype is not None:
        kw["compute_dtype"] = dtype
    return dataclasses.replace(cfg, **kw)


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in float64 on the host."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def median_ms(fn, reps: int, device) -> float:
    """Median wall ms of ``fn()`` over ``reps`` runs after one warm-up, each
    ending in a device sync."""
    fn()
    sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


BUSY_STEPS = 5


def count_aten_ops(fn) -> int:
    """The aten operators ``fn()`` dispatches (views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def decode_busy_share(fn, device):
    """Device busy time / wall over BUSY_STEPS calls of ``fn`` under
    ``torch.profiler`` (None off the card).  Only the device's activity is
    traced: host-op events would add the profiler's own work to the wall
    and are never read."""
    if torch.device(device).type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BUSY_STEPS):
            fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / wall_us


def phase_models(card: str, device: str = "cuda",
                 layers: int | None = None) -> dict:
    """``DecoderLM`` at full width: decode token by token == forward within
    DECODE_TOL (bf16); at PARITY_LAYERS layers and float32 compute the
    card's logits == the CPU's on the same weights within F32_TOL; prefill
    ms of a PREFILL_SHAPE batch and decode ms a step at B = 3 (medians),
    peak device memory."""
    cfg = ml_config(layers)
    reset_peak(device)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=ML_SEED)
    model.compute_params()
    sync(device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[models] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to "
        f"{model.embedding.shape[0]}; {n_params / 1e9:.3f} B float32 "
        f"parameters and their {cfg.compute_dtype} copy built in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(ML_SEED)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                           device=device)
    full, _ = model.forward(toks)
    cache = model.init_cache(2, 64)
    steps = []
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(
            cache, toks[:, t:t + 1],
            torch.full((2,), t, dtype=torch.int32, device=device))
        steps.append(logits[:, 0])
    dec = torch.stack(steps, 1)
    d_dec = rel_diff(dec, full)
    agree = float((dec.argmax(-1) == full.argmax(-1)).double().mean())
    log(f"[models] decode token by token vs forward, (2, 32), bf16: max "
        f"|diff| {d_dec:.3e} of max |logit| {float(full.abs().max()):.2f} "
        f"(tolerance {DECODE_TOL:.3e}); argmax agrees at {agree:.3f} of "
        "the positions")
    if not d_dec <= DECODE_TOL or not torch.isfinite(full).all():
        raise AssertionError(f"[models] decode differs from forward by "
                             f"{d_dec:.3e} (> {DECODE_TOL:.3e})")
    del dec, full, cache, steps

    shape = PREFILL_SHAPE
    ptoks = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape),
                            device=device)
    prefill = median_ms(lambda: model.prefill(ptoks), 5, device)
    dcache = model.init_cache(3, 512)
    dtok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 1)),
                           device=device)
    pos = [0]

    def one_step():
        p = torch.full((3,), pos[0], dtype=torch.int32, device=device)
        model.decode_step(dcache, dtok, p)
        pos[0] += 1

    decode = median_ms(one_step, 20, device)
    peak = peak_mib(device)
    n_ops = count_aten_ops(one_step)
    busy = decode_busy_share(one_step, device)
    log(f"[models] a decode step dispatches {n_ops} aten ops "
        f"({n_ops / cfg.num_layers:.0f} a layer); device busy "
        f"{'not measured' if busy is None else f'{100 * busy:.1f}%'} of the "
        f"wall over {BUSY_STEPS} profiled steps")
    tokens = shape[0] * shape[1]
    log(f"[models] {card}: prefill {shape} {prefill:.3f} ms median "
        f"({tokens / prefill * 1e3:.0f} tokens/s); decode at B = 3 "
        f"{decode:.3f} ms a step median ({3 / decode * 1e3:.1f} tokens/s); "
        f"peak device memory "
        f"{'not measured' if peak is None else f'{peak:.1f} MiB'}")
    del model, dcache, ptoks

    # card against CPU: the same weights, float32 compute
    cfg32 = ml_config(PARITY_LAYERS, "float32")
    small = build_model(cfg32, device=device, seed=ML_SEED)
    twin = build_model(cfg32, device="cpu", seed=ML_SEED + 1)
    twin.load_state_dict({k: v.cpu() for k, v in small.state_dict().items()})
    toks = torch.as_tensor(rng.integers(0, cfg32.vocab_size, (2, 32)))
    d32 = rel_diff(small.forward(toks.to(device))[0], twin.forward(toks)[0])
    log(f"[models] {PARITY_LAYERS} layers at full width, float32 compute "
        f"(TF32 off), (2, 32): card vs CPU logits max |diff| {d32:.3e} of "
        f"max |logit| (tolerance {F32_TOL:.0e})")
    if not d32 <= F32_TOL:
        raise AssertionError(f"[models] card and CPU logits differ by "
                             f"{d32:.3e} (> {F32_TOL:.0e})")
    return dict(decode_rel=d_dec, f32_rel=d32, prefill_ms=prefill,
                decode_ms=decode, peak_mib=peak, params=n_params,
                decode_ops=n_ops, decode_busy=busy)


def serve_requests(engine, cfg, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               SERVE["prompt"])
                    .astype(np.int32), max_new=SERVE["max_new"])
            for i in range(SERVE["requests"])]
    for r in reqs:
        engine.submit(r)
    return reqs


def phase_serve(card: str, device: str = "cuda",
                layers: int | None = None) -> dict:
    """``ServeEngine`` at full width: serve_batched.py's shape at max_len
    512; every request done with max_new tokens, the same tokens from a
    second engine of the same seed; at PARITY_LAYERS layers and float32
    compute, the card's tokens == the CPU engine's on the same weights."""
    cfg = ml_config(layers)
    runs = []
    for rep in range(2):
        reset_peak(device)
        eng = ServeEngine(cfg, batch_slots=SERVE["slots"],
                          max_len=SERVE["max_len"], seed=ML_SEED,
                          device=device)
        reqs = serve_requests(eng, cfg)
        sync(device)
        t0 = time.perf_counter()
        steps = eng.run()
        sync(device)
        wall = time.perf_counter() - t0
        toks = [r.out_tokens for r in reqs]
        if not all(r.done and len(r.out_tokens) == SERVE["max_new"]
                   for r in reqs):
            raise AssertionError(f"[serve] a request was not served: "
                                 f"{[(r.done, len(r.out_tokens)) for r in reqs]}")
        runs.append(dict(steps=steps, wall=wall, toks=toks,
                         peak=peak_mib(device)))
        del eng
    if runs[0]["toks"] != runs[1]["toks"]:
        raise AssertionError("[serve] a second engine of the same seed gave "
                             "other tokens")
    run = runs[1]
    fills = SERVE["requests"] * SERVE["prompt"]
    n_tok = SERVE["requests"] * SERVE["max_new"]
    calls = run["steps"] + fills
    peak = run["peak"]
    log(f"[serve] {card}: {cfg.name} ({cfg.num_layers} layers) "
        f"{SERVE['requests']} requests x {SERVE['max_new']} tokens, "
        f"{SERVE['slots']} slots, max_len {SERVE['max_len']}: "
        f"{run['steps']} decode steps + {fills} prefill fill steps in "
        f"{run['wall']:.3f} s ({run['wall'] / calls * 1e3:.3f} ms a step), "
        f"{n_tok / run['wall']:.1f} generated tokens/s; peak device memory "
        f"{'not measured' if peak is None else f'{peak:.1f} MiB'}; the "
        "same tokens from a second engine of the same seed")

    cfg32 = ml_config(PARITY_LAYERS, "float32")
    engs = [ServeEngine(cfg32, batch_slots=SERVE["slots"],
                        max_len=SERVE["max_len"], seed=ML_SEED, device=d)
            for d in (device, "cpu")]
    engs[1].model.load_state_dict(
        {k: v.cpu() for k, v in engs[0].model.state_dict().items()})
    got = []
    for eng in engs:
        reqs = serve_requests(eng, cfg32)
        eng.run()
        got.append([r.out_tokens for r in reqs])
    if got[0] != got[1]:
        raise AssertionError(f"[serve] {PARITY_LAYERS}-layer float32 tokens "
                             f"differ, card {got[0]} vs CPU {got[1]}")
    log(f"[serve] {PARITY_LAYERS} layers at full width, float32 compute: "
        f"the card's tokens == the CPU engine's for all "
        f"{SERVE['requests']} requests")
    return dict(steps=run["steps"], fills=fills, wall_s=run["wall"],
                ms_per_step=run["wall"] / calls * 1e3,
                tok_per_s=n_tok / run["wall"], peak_mib=peak)


def phase_ola_eval(card: str, device: str = "cuda",
                   layers: int | None = None) -> dict:
    """``ola_eval`` over the full-width model's per-example loss on
    ola_eval_demo.py's shards (24 of 64-127 examples of 65 tokens):
    within 3·ε of the exhaustive mean computed on the card, on fewer
    examples than the set holds."""
    cfg = ml_config(layers)
    model = build_model(cfg, device=device, seed=ML_SEED)
    model.compute_params()
    shards = ola_eval_demo.eval_shards(cfg)
    total = sum(len(s) for s in shards)

    def loss_of(ex):
        return ola_eval_demo.per_example_loss(
            model, torch.as_tensor(ex, device=device))

    sync(device)
    t0 = time.perf_counter()
    res = ola_eval(loss_of, shards, device=device, **OLA_EVAL)
    sync(device)
    ola_s = time.perf_counter() - t0
    full = float(torch.cat([loss_of(s) for s in shards]).double().mean())
    sync(device)
    wall = time.perf_counter() - t0
    eps = OLA_EVAL["epsilon"]
    log(f"[ola-eval] {card}: {cfg.name} ({cfg.num_layers} layers): "
        f"estimate {res.estimate:.4f} [{res.lo:.4f}, {res.hi:.4f}] on "
        f"{res.examples_used} of {total} examples "
        f"({100 * res.examples_used / total:.1f}%, {res.shards_used} "
        f"shards) in {ola_s:.3f} s; exhaustive mean {full:.4f} "
        f"({100 * abs(res.estimate - full) / abs(full):.3f}% off, "
        f"{wall - ola_s:.3f} s)")
    if not (abs(res.estimate - full) <= 3 * eps * abs(full)
            and res.examples_used < total and np.isfinite(full)):
        raise AssertionError(f"[ola-eval] estimate {res.estimate} vs "
                             f"exhaustive {full} (3·ε = {3 * eps}), "
                             f"{res.examples_used} of {total} examples")
    return dict(estimate=res.estimate, exhaustive=full,
                used=res.examples_used, total=total, ola_s=ola_s,
                exhaustive_s=wall - ola_s)


def phase_ingest(device: str = "cuda") -> dict:
    """``IngestGate(standard_ingest_queries(0.05))`` over the corpus's
    metadata stores, card against CPU: the same decisions, failed queries
    and tuples ratios; every poisoned segment rejected and every clean one
    admitted; kernel 1 launched during the card's checks."""
    t0 = time.perf_counter()
    corpus = SyntheticCorpus(**CORPUS)
    log(f"[ingest] corpus: {len(corpus.segments)} segments x "
        f"{CORPUS['docs_per_segment']} documents of {CORPUS['doc_len']} "
        f"tokens (vocab {CORPUS['vocab']}), metadata as "
        f"{corpus.segments[0].meta_store.codec.record_bytes}-byte ASCII "
        f"records in {corpus.segments[0].meta_store.num_chunks} chunks a "
        f"segment; {time.perf_counter() - t0:.2f} s")
    queries = standard_ingest_queries(0.05)
    reset_launches()
    t0 = time.perf_counter()
    card_d = [IngestGate(queries, device=device).check(s.meta_store)
              for s in corpus.segments]
    sync(device)
    card_s = time.perf_counter() - t0
    launches = launch_counts()["slot_extract"]
    cpu_d = [IngestGate(queries, device="cpu").check(s.meta_store)
             for s in corpus.segments]
    for seg, a, b in zip(corpus.segments, card_d, cpu_d):
        if (a.admitted, a.failed_query, a.tuples_ratio) != \
                (b.admitted, b.failed_query, b.tuples_ratio):
            raise AssertionError(
                f"[ingest] segment {seg.index}: card {a.admitted, a.failed_query, a.tuples_ratio} "
                f"vs CPU {b.admitted, b.failed_query, b.tuples_ratio}")
        if a.admitted == seg.poison:
            raise AssertionError(f"[ingest] segment {seg.index} (poison "
                                 f"{seg.poison}) admitted={a.admitted}")
    rounds = sum(r.rounds for d in card_d for r in d.results)
    log(f"[ingest] card == CPU for every segment: admitted "
        f"{[d.admitted for d in card_d]} (poisoned "
        f"{[s.poison for s in corpus.segments]}), failed "
        f"{[d.failed_query or '-' for d in card_d]}, tuples ratio "
        f"{[round(d.tuples_ratio, 4) for d in card_d]}; {rounds} engine "
        f"rounds, kernel 1 launches {launches}, {card_s:.2f} s on the card")
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError("[ingest] kernel 1 never launched")
    return dict(launches=launches, rounds=rounds, card_s=card_s)


def phase_examples(device: str = "cuda") -> dict:
    """Each port example's ``main()`` in-process on the device with its
    defaults; quickstart's and serve_ola_workload's answers within 3·ε of
    their exact values."""
    reset_launches()
    secs = {}
    args = [] if torch.device(device).type == "cuda" else ["--device",
                                                            device]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mod in EXAMPLES.items():
            extra = []
            if name == "trace_workload":
                extra = ["--out", os.path.join(tmp, "ola_trace.json")]
            elif name == "train_with_verification":
                extra = ["--steps", str(EXAMPLE_TRAIN_STEPS)]
            t0 = time.perf_counter()
            with open(os.devnull, "w") as sink, \
                    contextlib.redirect_stdout(sink):
                out[name] = mod.main(args + extra)
            sync(device)
            secs[name] = time.perf_counter() - t0
    q = out["quickstart"]
    worst = [abs(float(q["result"].final_estimate[0]) - q["exact"])
             / (q["query"].epsilon * abs(q["exact"]))]
    s = out["serve_ola_workload"]
    x = s["values"] @ np.asarray([1.0 / (k + 1) for k in range(8)])
    exact = {"sum-all": x.sum(), "sum-tight": x.sum(), "avg-all": x.mean()}
    eps = {qq.name: qq.epsilon for qq in s["queries"]}
    for r in s["results"]:
        if r.name in exact:
            worst.append(abs(r.estimate - exact[r.name])
                         / (eps[r.name] * abs(exact[r.name])))
    if not max(worst) <= 3.0:
        raise AssertionError(f"[examples] an answer misses 3·ε: {worst}")
    if not out["explore_ptf"]["passed"] or \
            not out["serve_batched"]["report"]["all_done"]:
        raise AssertionError("[examples] explore_ptf rejected its batch or "
                             "serve_batched left a request")
    # train_with_verification: the example's corpus, gated as on the CPU
    tv = out["train_with_verification"]
    check_gates(tv["log"], SyntheticCorpus(
        vocab=get_config(TRAIN_ARCH, reduced=True).vocab_size,
        **TRAIN_CORPUS), TrainerConfig().gate_epsilon, "examples")
    tv_losses = [e["loss"] for e in tv["log"] if e["event"] == "step"]
    if tv["result"]["steps"] != EXAMPLE_TRAIN_STEPS or \
            not np.isfinite(tv_losses).all():
        raise AssertionError(f"[examples] train_with_verification: "
                             f"{tv['result']}")
    launches = launch_counts()["slot_extract"]
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError("[examples] kernel 1 never launched")
    log(f"[examples] "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f"; worst answer {max(worst):.3f}·ε; kernel 1 launches {launches}")
    return dict(secs=secs, launches=launches, worst=max(worst))


# ------------------------------------------------------------ training ----
# The training plane: smollm-135m (the reference's end-to-end training
# arch) at its published widths (30 layers, d_model 576, 9 Q / 3 KV heads
# of 64, SwiGLU 1536, vocab 49,152, tied, bf16 compute, remat on), trained
# from random weights through the OLA ingest gate on
# examples/train_with_verification.py's corpus at its batch (4 x 128).
# 6 of the 8 segments are clean, so 5 steps a segment make 30 steps;
# checkpoints every 15 steps keep the run to two saves of the ~1.6 GB
# float32 state (params, mu, nu), and the failure one step after the
# first restores it.
TRAIN_ARCH = "smollm-135m"
TRAIN = dict(steps_per_segment=5, batch=4, seq_len=128, max_steps=30,
             ckpt_every=15)
TRAIN_CORPUS = dict(num_segments=8, docs_per_segment=128, doc_len=128,
                    poison_every=3, seed=0)
TRAIN_FAIL_AT = TRAIN["ckpt_every"] + 1
# card against CPU: the reduced model at float32 compute (TF32 off), four
# steps on fixed batches; the embedding's backward adds with atomics on
# the card, so the sums are not bit for bit
TRAIN_PARITY_STEPS = 4
TRAIN_PARITY_SHAPE = (4, 64)
TRAIN_TOL = 1e-4
TRAIN_TIME_REPS = 10
EXAMPLE_TRAIN_STEPS = 12


def token_batches(cfg, n: int, shape: tuple, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (shape[0], shape[1] + 1))
        out.append({"tokens": torch.as_tensor(toks[:, :-1],
                                              dtype=torch.int32),
                    "labels": torch.as_tensor(toks[:, 1:],
                                              dtype=torch.int32)})
    return out


def check_gates(log: list, corpus, epsilon: float, tag: str) -> list:
    """Every segment gated; each ``gate`` event of a trainer's log equal to
    the CPU gate's decision on that segment; poisoned segments rejected,
    clean ones admitted.  Returns the events."""
    gates = [e for e in log if e["event"] == "gate"]
    if [e["segment"] for e in gates] != [s.index for s in corpus.segments]:
        raise AssertionError(f"[{tag}] gated segments "
                             f"{[e['segment'] for e in gates]}")
    cpu = IngestGate(standard_ingest_queries(epsilon), device="cpu")
    for e in gates:
        seg = corpus.segments[e["segment"]]
        d = cpu.check(seg.meta_store)
        if (e["admitted"], e["failed"], e["tuples_ratio"]) != \
                (d.admitted, d.failed_query, d.tuples_ratio):
            raise AssertionError(
                f"[{tag}] segment {seg.index}: "
                f"{e['admitted'], e['failed'], e['tuples_ratio']} vs the "
                f"CPU gate's {d.admitted, d.failed_query, d.tuples_ratio}")
        if e["admitted"] == seg.poison:
            raise AssertionError(f"[{tag}] segment {seg.index} (poison "
                                 f"{seg.poison}) admitted={e['admitted']}")
    return gates


def cpu_tree(tree):
    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def train_parity(device: str) -> dict:
    """The reduced model at float32 compute: the same torch-initialised
    tree on the card and the CPU, TRAIN_PARITY_STEPS steps on fixed
    batches; per-step losses and the first grad_norm within TRAIN_TOL."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True),
                              compute_dtype="float32")
    model = build_model(cfg, device="cpu", seed=ML_SEED)
    tree = tree_from_module(model)
    step = make_train_step(model.loss_fn, AdamWConfig(warmup_steps=2))
    batches = token_batches(cfg, TRAIN_PARITY_STEPS, TRAIN_PARITY_SHAPE)
    got = {}
    for dev in (device, "cpu"):
        # the step updates its state in place (donated): each device's
        # run starts from its own copy of the tree
        state = init_train_state(tree_map(lambda t: t.to(dev, copy=True),
                                          tree))
        ms = []
        for b in batches:
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        got[dev] = ms
    card, cpu = np.asarray(got[device]), np.asarray(got["cpu"])
    loss_rel = float(np.max(np.abs(card[:, 0] - cpu[:, 0])
                            / np.abs(cpu[:, 0])))
    norm_rel = float(abs(card[0, 1] - cpu[0, 1]) / abs(cpu[0, 1]))
    log(f"[train] {cfg.name} reduced ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}), float32 compute (TF32 off), {TRAIN_PARITY_STEPS} "
        f"steps of {TRAIN_PARITY_SHAPE}: card vs CPU losses "
        f"{[round(float(x), 5) for x in card[:, 0]]}, max rel diff "
        f"{loss_rel:.3e}; "
        f"first grad_norm rel diff {norm_rel:.3e} (tolerance {TRAIN_TOL:.0e})")
    if not (loss_rel <= TRAIN_TOL and norm_rel <= TRAIN_TOL):
        raise AssertionError(f"[train] card and CPU steps differ: losses "
                             f"{loss_rel:.3e}, grad_norm {norm_rel:.3e}")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel)


def phase_train(card: str, device: str = "cuda", cfg=None) -> dict:
    """The training plane: ``train_parity``, then ``Trainer`` at full width
    (``cfg``, smollm-135m unless given) over the example's corpus with a
    failure one step after the first checkpoint: every segment gated as the
    CPU gate decides, kernel 1 launched, one restart, the restored state
    equal bit for bit to the checkpoint the state was saved to, every loss
    finite and the mean of the last five below that of the first five; then
    the ms a step (median, host clock ending in a sync), tokens a second,
    peak device memory, aten ops a step and the device's busy share."""
    parity = train_parity(device)
    cfg = cfg or get_config(TRAIN_ARCH)
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, **TRAIN_CORPUS)
    saves, restores = [], []
    real_save = train_ckpt.save

    def timed_save(directory, step, state, **kw):
        sync(device)
        t0 = time.perf_counter()
        out = real_save(directory, step, state, **kw)
        saves.append(dict(step=step, s=time.perf_counter() - t0,
                          state=None if saves else cpu_tree(state)))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainerConfig(**TRAIN, ckpt_dir=tmp)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, tcfg, injector=FailureInjector(
            fail_at_steps=(TRAIN_FAIL_AT,), kill_devices=0), device=device)
        build_s = time.perf_counter() - t0
        real_recover = trainer._recover

        def timed_recover(state, killed):
            sync(device)
            t0 = time.perf_counter()
            out = real_recover(state, killed)
            sync(device)
            restores.append(dict(s=time.perf_counter() - t0,
                                 state=cpu_tree(out)))
            return out

        trainer._recover = timed_recover
        reset_launches()
        reset_peak(device)
        train_ckpt.save = timed_save
        try:
            result = trainer.run(corpus)
        finally:
            train_ckpt.save = real_save
        sync(device)
        launches = launch_counts()["slot_extract"]
        run_peak = peak_mib(device)
        with np.load(os.path.join(tmp, f"step_{TRAIN['ckpt_every']}",
                                  "arrays.npz")) as z:
            on_disk = {k: z[k] for k in z.files}

    gates = check_gates(trainer.log, corpus, tcfg.gate_epsilon, "train")
    steps = [e for e in trainer.log if e["event"] == "step"]
    losses = np.asarray([e["loss"] for e in steps])
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError("[train] kernel 1 never launched")
    if result["restarts"] != 1 or len(restores) != 1 or \
            result["steps"] != TRAIN["max_steps"]:
        raise AssertionError(f"[train] {result['steps']} steps, "
                             f"{result['restarts']} restarts")
    # the restore: the first checkpoint's state, bit for bit, three ways
    restored = dict(leaves_with_paths(restores[0]["state"]))
    saved = dict(leaves_with_paths(saves[0]["state"]))
    keys = ["/".join(map(str, k)) for k in restored]
    if sorted(keys) != sorted(on_disk) or list(restored) != list(saved):
        raise AssertionError("[train] the restored state's leaves are not "
                             "the checkpoint's")
    for (path, leaf), key in zip(restored.items(), keys):
        if not (torch.equal(leaf, saved[path]) and np.array_equal(
                leaf.numpy(), on_disk[key])):
            raise AssertionError(f"[train] restored {key} differs from the "
                                 "checkpoint")
    if int(restores[0]["state"].step) != TRAIN["ckpt_every"]:
        raise AssertionError("[train] restored the wrong step")
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"[train] losses not finite and falling: "
                             f"first five {first}, last five {last}")
    k = max(len(losses) // 8, 1)
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}; trainer built in "
        f"{build_s:.2f} s; {result['steps']} steps of {TRAIN['batch']} x "
        f"{TRAIN['seq_len']} in {result['wall_s']:.2f} s (gate, "
        f"checkpoints and the restore included); admitted "
        f"{result['admitted']}, rejected {result['rejected']} (segments "
        f"{[e['segment'] for e in gates if not e['admitted']]}, as the CPU "
        f"gate), tuples ratio {[round(e['tuples_ratio'], 4) for e in gates]}"
        f"; kernel 1 launches {launches}; restarts {result['restarts']}")
    log(f"[train] loss curve {' '.join(f'{x:.3f}' for x in losses[::k])}; "
        f"mean of the first five {first:.4f}, of the last five {last:.4f}; "
        f"checkpoint saves "
        + ", ".join(f"step {x['step']} {x['s']:.2f} s" for x in saves)
        + f"; "
        f"restore of step {TRAIN['ckpt_every']} at step {TRAIN_FAIL_AT} "
        f"{restores[0]['s']:.2f} s, equal bit for bit to the saved state "
        f"and the file ({len(keys)} arrays)")

    state = result["state"]
    batch = {k: v.to(device) for k, v in token_batches(
        cfg, 1, (TRAIN["batch"], TRAIN["seq_len"]), seed=1)[0].items()}

    def one_step():
        trainer.step_fn(state, batch)

    sync(device)
    state_mib = sum(t.numel() * t.element_size()
                    for t in leaves(state)) / 2**20
    resident = (torch.cuda.memory_allocated() / 2**20
                if torch.device(device).type == "cuda" else None)
    mark = step_mark(device)
    t0 = time.perf_counter()
    step_ms = median_ms(one_step, TRAIN_TIME_REPS, device)
    step_bytes = step_high(device, mark)
    peak = peak_mib(device)
    t1 = time.perf_counter()
    n_ops = count_aten_ops(one_step)
    t2 = time.perf_counter()
    busy = decode_busy_share(one_step, device)
    secs = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    tokens = TRAIN["batch"] * TRAIN["seq_len"]
    log(f"[train] {card}: a train step of {TRAIN['batch']} x "
        f"{TRAIN['seq_len']} {step_ms:.3f} ms median of "
        f"{TRAIN_TIME_REPS} ({tokens / step_ms * 1e3:.0f} tokens/s); "
        f"{n_ops} aten ops a step; device busy "
        f"{'not measured' if busy is None else f'{100 * busy:.1f}%'} of the "
        f"wall over {BUSY_STEPS} profiled steps; peak device memory "
        f"{'not measured' if peak is None else f'{peak:.1f} MiB'} "
        f"(the trainer's run: "
        f"{'not measured' if run_peak is None else f'{run_peak:.1f} MiB'}"
        f"; the state, params + mu + nu, {state_mib:.1f} MiB; allocated "
        f"before a step "
        f"{'not measured' if resident is None else f'{resident:.1f} MiB'}"
        f", so a step adds "
        f"{'not measured' if peak is None else f'{peak - resident:.1f} MiB'}"
        f"; the step's own high-water mark above what was allocated before "
        f"it "
        f"{'not measured' if step_bytes is None else f'{step_bytes / 2**20:.1f} MiB'}"
        f" beside the state's {state_mib:.1f} MiB: the state is donated, "
        f"updated in place); "
        f"timed in {secs[0]:.1f} s, counted in {secs[1]:.1f} s, profiled in "
        f"{secs[2]:.1f} s")
    return dict(parity=parity, launches=launches, steps=result["steps"],
                step_ms=step_ms, tok_per_s=tokens / step_ms * 1e3,
                step_bytes=step_bytes,
                ops=n_ops, busy=busy, peak_mib=peak, run_peak_mib=run_peak,
                state_mib=state_mib, resident_mib=resident,
                save_s=[x["s"] for x in saves], restore_s=restores[0]["s"],
                first=first, last=last)


# ------------------------------------------------------ other families ----
# The five families beyond the dense decoder at their published widths
# (configs/*.py), bf16, random weights from ML_SEED on the card's
# generator, one model at a time, each released before the next.  The MoE
# pair is cut in depth only, to 4 of its 32 layers (1.45 B and 1.30 B
# parameters a layer: ~36 and ~33 GB at 6 bytes a parameter).
FAMILIES = (("mixtral-8x7b", 4), ("phi3.5-moe-42b-a6.6b", 4),
            ("qwen2-vl-2b", None), ("whisper-large-v3", None),
            ("zamba2-1.2b", None), ("xlstm-125m", None))
FAM_PREFILL = 512            # prefill positions at B = 1 (the VLM: 256
                             # patches on a 16 x 16 grid + 256 text tokens)
FAM_ENC_FRAMES = 1500        # Whisper's published encoder length
FAM_XLSTM_PREFILL = 1024     # > 2 x chunk 256: the chunkwise mLSTM runs
FAM_DECODE_B = 3
FAM_DECODE_STEPS = 10        # decode steps timed (median)
FAM_CHECK_SHAPE = (2, 16)    # decode vs forward and card vs CPU tokens
FAM_ORACLE_TOL = 2e-3        # the reference oracle's rtol = atol
# decode vs forward at float32 runs every layer but the MoE pair's (2,
# capacity factor 8: no drops in either dispatch) and the hybrid's (12 of
# 38: two shared-attention sites; float32 rounding grows with depth, and
# at full width the reference's own float32 decode reaches the oracle's
# tolerance at 12 layers, tools/decode_drift.py; all 38 are read, not
# gated); card vs CPU at float32 runs one MoE layer, 2 of the VLM and the
# encoder-decoder, the hybrid's first 6 (its first shared-attention site)
# and all 12 of xlstm-125m (its sLSTM blocks sit at 5 and 11)
FAM_ORACLE_LAYERS = {"moe": 2, "hybrid": 12}
FAM_PARITY_LAYERS = {"moe": 1, "vlm": 2, "encdec": 2, "hybrid": 6}
NEAR_TIE = 1e-6              # a top-(k+1) probability gap counted as a tie
FAM_SERVE_ARCH = "zamba2-1.2b"


def fam_config(arch: str, layers=None, dtype=None, **kw):
    cfg = get_config(arch)
    if layers:
        kw["num_layers"] = layers
    if dtype:
        kw["compute_dtype"] = dtype
    return dataclasses.replace(cfg, **kw)


@contextlib.contextmanager
def recorded_dispatch():
    """Every MoE dispatch run inside: [(probs, (gate, ids, pos, keep))]."""
    rec = []
    real = moe_mod.moe_dispatch

    def spy(probs, k, cap):
        out = real(probs, k, cap)
        rec.append((probs, out))
        return out

    moe_mod.moe_dispatch = spy
    try:
        yield rec
    finally:
        moe_mod.moe_dispatch = real


def near_ties(rec, k: int) -> int:
    """Tokens whose top k+1 router probabilities hold two within
    NEAR_TIE (a choice that float rounding could flip)."""
    n = 0
    for probs, _ in rec:
        top = torch.sort(probs, -1, descending=True).values[..., :k + 1]
        n += int(((top[..., :-1] - top[..., 1:]) < NEAR_TIE).any(-1).sum())
    return n


def fam_batch(cfg, b: int, s: int, device, seed: int = 0,
              frames: int = 64) -> dict:
    """A batch of the family's shape with ``s`` token positions: tokens;
    the VLM's patch embeddings (half of ``s``, on a square grid) and
    M-RoPE ids; the encoder-decoder's ``frames`` frame embeddings."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, cfg.compute_dtype)
    out = {}
    if cfg.family == "vlm":
        sv = s // 2
        out["vis_embeds"] = torch.as_tensor(
            rng.normal(size=(b, sv, cfg.d_model)), device=device).to(dt)
        out["positions3"] = torch.as_tensor(
            build_positions3(b, sv, s - sv), device=device)
        s -= sv
    if cfg.family == "encdec":
        out["enc_embeds"] = torch.as_tensor(
            rng.normal(size=(b, frames, cfg.d_model)), device=device).to(dt)
    out["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                    device=device)
    return out


def fam_logits(model, batch: dict) -> torch.Tensor:
    """The full-sequence forward's logits of any family."""
    if model.cfg.family in ("vlm", "encdec"):
        out = model.forward(batch)
    else:
        out = model.forward(batch["tokens"])
    return out[0] if isinstance(out, tuple) else out


def fam_decoder(model, batch: dict, b: int, max_len: int, dtype=None):
    """A decode-step function ``step(tokens, pos) -> logits`` over a fresh
    cache of ``dtype`` (the family's default when None; the
    encoder-decoder's over ``batch``'s encoder output)."""
    cache = model.init_cache(b, max_len,
                             **({} if dtype is None else {"dtype": dtype}))
    if model.cfg.family == "encdec":
        ckv = model.precompute_cross(model.encode(batch["enc_embeds"]))
        return lambda tok, pos: model.decode_step(cache, tok, pos, ckv)[0]
    return lambda tok, pos: model.decode_step(cache, tok, pos)[0]


def fam_oracle(arch: str, device, layers=None) -> dict:
    """The reference's decode == forward oracle at full width and float32
    compute: teacher-forced decode over FAM_CHECK_SHAPE's tokens against
    the full-sequence forward, ``ratio`` the max of |decode - forward| /
    (atol + rtol · |forward|), <= 1 passes.  The VLM decodes text only:
    its forward gets no patches and all three M-RoPE streams at the
    token's position.  ``layers`` overrides FAM_ORACLE_LAYERS."""
    cfg = get_config(arch)
    cfg = fam_config(arch, layers or FAM_ORACLE_LAYERS.get(cfg.family),
                     "float32",
                     **({"capacity_factor": 8.0} if cfg.family == "moe"
                        else {}))
    b, s = FAM_CHECK_SHAPE
    batch = fam_batch(cfg, b, s, device, frames=FAM_ENC_FRAMES)
    if cfg.family == "vlm":
        batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (b, s)), device=device),
            "vis_embeds": torch.zeros(b, 0, cfg.d_model, device=device),
            "positions3": torch.arange(s, device=device).expand(3, b, s)}
    toks = batch["tokens"]
    model = build_model(cfg, device=device, seed=ML_SEED)
    if cfg.family == "encdec":
        full = model.decode_full(toks, model.encode(batch["enc_embeds"]))
    else:
        full = fam_logits(model, batch)
    step = fam_decoder(model, batch, b, 64, torch.float32)
    dec = torch.stack([step(toks[:, t:t + 1], torch.full(
        (b,), t, dtype=torch.int32, device=device))[:, 0]
        for t in range(s)], 1)
    diff = (dec - full).abs()
    return dict(layers=cfg.num_layers,
                ratio=float((diff / (FAM_ORACLE_TOL * (1 + full.abs()))).max()),
                diff=float(diff.max()), scale=float(full.abs().max()))


def fam_parity(arch: str, device) -> dict:
    """Card against CPU at float32 (TF32 off), full width, the depth of
    FAM_PARITY_LAYERS: the same weights (the card's, copied into a CPU
    module built on the meta device), logits within F32_TOL; the MoE
    pair's dispatch (expert ids, positions, kept mask) equal on both."""
    cfg = get_config(arch)
    cfg = fam_config(arch, FAM_PARITY_LAYERS.get(cfg.family), "float32")
    card = build_model(cfg, device=device, seed=ML_SEED)
    twin = build_model(cfg, device="meta")
    twin.to_empty(device="cpu")
    twin.load_state_dict(card.state_dict())
    b, s = FAM_CHECK_SHAPE
    batch = fam_batch(cfg, b, s, "cpu")
    with recorded_dispatch() as rec_card:
        got = fam_logits(card, {k: v.to(device) for k, v in batch.items()})
    with recorded_dispatch() as rec_cpu:
        want = fam_logits(twin, batch)
    out = dict(layers=cfg.num_layers, rel=rel_diff(got, want))
    if cfg.family == "moe":
        same = len(rec_card) == len(rec_cpu) == cfg.num_layers and all(
            torch.equal(x.cpu(), y) for (_, a), (_, c) in zip(rec_card, rec_cpu)
            for x, y in zip(a[1:], c[1:]))
        out.update(dispatch_equal=same,
                   near_ties=near_ties(rec_cpu, cfg.top_k),
                   tokens=sum(p.shape[0] * p.shape[1] for p, _ in rec_cpu))
    return out


def fam_timing(arch: str, layers, device) -> dict:
    """The bf16 model at full width: prefill ms (median of 2) of its
    FAM_PREFILL-shaped input at B = 1, decode ms a step at B = 3 (median of
    FAM_DECODE_STEPS), aten ops a decode step, peak device memory, the
    MoE pair's dropped-token share in the prefill."""
    cfg = fam_config(arch, layers)
    reset_peak(device)
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, seed=ML_SEED)
    model.compute_params()
    sync(device)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    s = FAM_XLSTM_PREFILL if cfg.family == "xlstm" else FAM_PREFILL
    batch = fam_batch(cfg, 1, s, device, frames=FAM_ENC_FRAMES)
    with recorded_dispatch() as rec:
        logits = fam_logits(model, batch)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"[families] {arch}: prefill logits not finite")
    drop = None
    if rec:
        kept = sum(int(o[3].sum()) for _, o in rec)
        total = sum(o[3].numel() for _, o in rec)
        drop = 1 - kept / total
    del logits, rec
    prefill = median_ms(lambda: fam_logits(model, batch), 2, device)
    step = fam_decoder(model, fam_batch(cfg, FAM_DECODE_B, 8, device,
                                        frames=FAM_ENC_FRAMES),
                       FAM_DECODE_B, 512)
    tok = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (FAM_DECODE_B, 1)), device=device)
    pos = [0]

    def one_step():
        step(tok, torch.full((FAM_DECODE_B,), pos[0], dtype=torch.int32,
                             device=device))
        pos[0] += 1

    decode = median_ms(one_step, FAM_DECODE_STEPS, device)
    n_ops = count_aten_ops(one_step)
    peak = peak_mib(device)
    del model, step, batch
    return dict(layers=cfg.num_layers, params=n_params, build_s=build_s,
                prefill_s=s, prefill_ms=prefill, decode_ms=decode,
                decode_ops=n_ops, peak_mib=peak, drop=drop)


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def phase_families(card: str, device: str = "cuda") -> dict:
    """Each family of FAMILIES: ``fam_timing`` (bf16), ``fam_oracle``
    (float32, within the oracle's tolerance) and ``fam_parity`` (float32,
    within F32_TOL, the MoE dispatch equal); then ``ServeEngine`` serves
    FAM_SERVE_ARCH at full width in serve_batched.py's shape (SERVE)."""
    out = {}
    for arch, layers in FAMILIES:
        t0 = time.perf_counter()
        r = fam_timing(arch, layers, device)
        release(device)
        r["oracle"] = fam_oracle(arch, device)
        release(device)
        r["parity"] = fam_parity(arch, device)
        release(device)
        r["s"] = time.perf_counter() - t0
        out[arch] = r
        par, o = r["parity"], r["oracle"]
        moe = ""
        if "dispatch_equal" in par:
            moe = (f"; dispatch card == CPU {par['dispatch_equal']} over "
                   f"{par['tokens']} tokens ({par['near_ties']} near ties); "
                   f"dropped-token share in the prefill "
                   f"{100 * r['drop']:.2f}%")
        peak = r["peak_mib"]
        log(f"[families] {card}: {arch} ({r['layers']} layers, "
            f"{r['params'] / 1e9:.3f} B float32 parameters and their bf16 "
            f"copy built in {r['build_s']:.2f} s): prefill of "
            f"{r['prefill_s']} positions {r['prefill_ms']:.3f} ms median; "
            f"decode at B = {FAM_DECODE_B} {r['decode_ms']:.3f} ms a step "
            f"median, {r['decode_ops']} aten ops a step; peak device memory "
            f"{'not measured' if peak is None else f'{peak:.1f} MiB'}; "
            f"decode vs forward at {o['layers']} layers, float32: "
            f"{o['ratio']:.3f} of the oracle's tolerance "
            f"({FAM_ORACLE_TOL:.0e}), max |diff| "
            f"{o['diff']:.3e} of max |logit| {o['scale']:.2f}; card vs CPU "
            f"at {par['layers']} layers, float32, logits {par['rel']:.3e} "
            f"(tolerance {F32_TOL:.0e}){moe}; {r['s']:.1f} s")
        if not (o["ratio"] <= 1.0
                and par["rel"] <= F32_TOL
                and par.get("dispatch_equal", True)):
            raise AssertionError(f"[families] {arch}: decode vs forward "
                                 f"{o}, card vs CPU {par}")
        full_depth = get_config(arch).num_layers
        if o["layers"] < full_depth and layers is None:
            deep = fam_oracle(arch, device, full_depth)
            release(device)
            out[arch]["oracle_full_depth"] = deep
            log(f"[families] {card}: {arch} decode vs forward at all "
                f"{full_depth} layers, float32 (not gated): {deep['ratio']:.3f}"
                f" of the oracle's tolerance, max |diff| {deep['diff']:.3e} "
                f"of max |logit| {deep['scale']:.2f}")
    cfg = get_config(FAM_SERVE_ARCH)
    reset_peak(device)
    eng = ServeEngine(cfg, batch_slots=SERVE["slots"],
                      max_len=SERVE["max_len"], seed=ML_SEED, device=device)
    reqs = serve_requests(eng, cfg)
    sync(device)
    t0 = time.perf_counter()
    steps = eng.run()
    sync(device)
    wall = time.perf_counter() - t0
    if not all(r.done and len(r.out_tokens) == SERVE["max_new"]
               for r in reqs):
        raise AssertionError("[families] ServeEngine left a request")
    n_tok = SERVE["requests"] * SERVE["max_new"]
    calls = steps + SERVE["requests"] * SERVE["prompt"]
    peak = peak_mib(device)
    log(f"[families] {card}: ServeEngine {cfg.name} ({cfg.num_layers} "
        f"layers) {SERVE['requests']} requests x {SERVE['max_new']} tokens, "
        f"{SERVE['slots']} slots, max_len {SERVE['max_len']}: {steps} decode "
        f"steps + {calls - steps} fill steps in {wall:.3f} s "
        f"({wall / calls * 1e3:.3f} ms a step), {n_tok / wall:.1f} generated "
        f"tokens/s; peak device memory "
        f"{'not measured' if peak is None else f'{peak:.1f} MiB'}")
    del eng
    release(device)
    out["serve"] = dict(steps=steps, wall_s=wall, tok_per_s=n_tok / wall,
                        ms_per_step=wall / calls * 1e3, peak_mib=peak)
    return out


# the token families' training: xlstm-125m at full width (12 layers,
# d_model 768, 4 heads, vocab 50,304, tied, bf16, remat) through Trainer on
# train_with_verification.py's corpus at its batch, one step a clean
# segment (6 steps); card vs CPU one step of each token family, reduced,
# float32
FAM_TRAIN_ARCH = "xlstm-125m"
FAM_TRAIN = dict(steps_per_segment=1, batch=4, seq_len=128, max_steps=6)
FAM_TRAIN_PARITY = ("mixtral-8x7b", "zamba2-1.2b", "xlstm-125m")
FAM_TRAIN_REPS = 2


def fam_train_parity(device) -> dict:
    """One train step of each token family's reduced config at float32
    from the same torch-initialised tree on the card and the CPU: loss and
    grad_norm within TRAIN_TOL."""
    out = {}
    for arch in FAM_TRAIN_PARITY:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  compute_dtype="float32")
        model = build_model(cfg, device="cpu", seed=ML_SEED)
        tree = tree_from_module(model)
        step = make_train_step(model.loss_fn, AdamWConfig(warmup_steps=2))
        batch = token_batches(cfg, 1, TRAIN_PARITY_SHAPE)[0]
        got = {}
        for dev in (device, "cpu"):
            state = init_train_state(tree_map(
                lambda t: t.to(dev, copy=True), tree))
            _, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            got[dev] = (float(m["loss"]), float(m["grad_norm"]))
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[device], got["cpu"]))
        out[arch] = dict(loss=got["cpu"][0], rel=rel)
        if not rel <= TRAIN_TOL:
            raise AssertionError(f"[families-train] {arch}: card {got[device]}"
                                 f" vs CPU {got['cpu']}")
    return out


def phase_families_train(card: str, device: str = "cuda") -> dict:
    """``fam_train_parity``, then ``Trainer`` at FAM_TRAIN_ARCH's full width
    over the example's corpus: every gate decision the CPU gate's, kernel 1
    launched by the gate (beside the gate's engine rounds), FAM_TRAIN's
    steps with finite losses; ms a step (median), tokens/s, aten ops a
    step, peak device memory."""
    parity = fam_train_parity(device)
    cfg = get_config(FAM_TRAIN_ARCH)
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, **TRAIN_CORPUS)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, TrainerConfig(**FAM_TRAIN), device=device)
    build_s = time.perf_counter() - t0
    decisions = []
    real_check = trainer.gate.check

    def recorded_check(store):
        decisions.append(real_check(store))
        return decisions[-1]

    trainer.gate.check = recorded_check
    reset_launches()
    reset_peak(device)
    result = trainer.run(corpus)
    sync(device)
    launches = launch_counts()["slot_extract"]
    rounds = sum(r.rounds for d in decisions for r in d.results)
    run_peak = peak_mib(device)
    gates = check_gates(trainer.log, corpus, trainer.tcfg.gate_epsilon,
                        "families-train")
    losses = [e["loss"] for e in trainer.log if e["event"] == "step"]
    if result["steps"] != FAM_TRAIN["max_steps"] or \
            not np.isfinite(losses).all():
        raise AssertionError(f"[families-train] {result['steps']} steps, "
                             f"losses {losses}")
    if torch.device(device).type == "cuda" and launches == 0:
        raise AssertionError("[families-train] kernel 1 never launched")
    state = result["state"]
    batch = {k: v.to(device) for k, v in token_batches(
        cfg, 1, (FAM_TRAIN["batch"], FAM_TRAIN["seq_len"]), seed=1)[0].items()}

    def one_step():
        trainer.step_fn(state, batch)

    reset_peak(device)
    step_ms = median_ms(one_step, FAM_TRAIN_REPS, device)
    peak = peak_mib(device)
    n_ops = count_aten_ops(one_step)
    tokens = FAM_TRAIN["batch"] * FAM_TRAIN["seq_len"]
    log(f"[families-train] card vs CPU, one reduced float32 step: "
        + ", ".join(f"{a} loss {v['loss']:.5f} rel {v['rel']:.3e}"
                    for a, v in parity.items())
        + f" (tolerance {TRAIN_TOL:.0e})")
    log(f"[families-train] {card}: {cfg.name} ({cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.compute_dtype}"
        f", remat {cfg.remat}); trainer built in {build_s:.2f} s; "
        f"{result['steps']} steps of {FAM_TRAIN['batch']} x "
        f"{FAM_TRAIN['seq_len']} in {result['wall_s']:.2f} s (the gate "
        f"included), admitted {result['admitted']}, rejected "
        f"{result['rejected']} (segments "
        f"{[e['segment'] for e in gates if not e['admitted']]}, as the CPU "
        f"gate); kernel 1 launches {launches} in the gate's {rounds} engine "
        f"rounds; losses {' '.join(f'{x:.3f}' for x in losses)}; a step "
        f"{step_ms:.3f} ms median of {FAM_TRAIN_REPS} "
        f"({tokens / step_ms * 1e3:.0f} tokens/s), {n_ops} aten ops a step; "
        f"peak device memory "
        f"{'not measured' if peak is None else f'{peak:.1f} MiB'} (the "
        f"run: {'not measured' if run_peak is None else f'{run_peak:.1f} MiB'})")
    return dict(parity=parity, launches=launches, rounds=rounds,
                steps=result["steps"], step_ms=step_ms,
                tok_per_s=tokens / step_ms * 1e3, ops=n_ops, peak_mib=peak,
                run_peak_mib=run_peak)


# ---------------------------------------------------- verify cell, shard --
# [verify-cell]: launch/verify_cell.py's production program at its widths
# (6 ASCII columns, 96-byte records, 65,536-tuple chunks, the three HAVING
# queries at eps 0.05, budget 256, one worker a rank) over VERIFY_RANKS
# gloo ranks on the one card; the chunk count cut from 4,096 to 256
# (16,777,216 tuples, 1,536 MiB raw) for host memory and the time limit
VERIFY_CHUNKS = 256
VERIFY_M = 65_536
VERIFY_COLS = 6
VERIFY_BUDGET = 256
VERIFY_RANKS = 2
VERIFY_ROUND_CAP = 400          # rounds at most to every query's stop
VERIFY_TIMED_ROUNDS = 50        # rounds timed after the stop
VERIFY_PARITY_ROUNDS = 8        # card == CPU over the first rounds
VERIFY_SEED = 5
# columns: 0 document length, 1 quality, 3 duplicate share; the others
# fill the record.  Uniform draws put avg_quality (> 75) and avg_dup (< 10)
# true and short_docs (< 1e6 rows with column 0 in [0, 16)) false
VERIFY_RANGES = ((0.0, 100.0), (60.0, 100.0), (0.0, 100.0), (0.0, 16.0),
                 (0.0, 100.0), (0.0, 100.0))
VERIFY_INTS = ("m", "offset", "closed", "raw_touched", "scan_m", "head",
               "round", "stopped", "decided", "tuples_round", "n_chunks",
               "m_tuples", "exhausted", "cpu_bound")
VERIFY_FLOATS = ("ysum", "ysq", "psum", "t_io", "t_cpu", "estimate", "lo",
                 "hi", "err", "bytes_round")


def verify_values() -> np.ndarray:
    rng = np.random.default_rng(VERIFY_SEED)
    lo = np.asarray([r[0] for r in VERIFY_RANGES])
    hi = np.asarray([r[1] for r in VERIFY_RANGES])
    return lo + (hi - lo) * rng.random((VERIFY_CHUNKS * VERIFY_M,
                                        VERIFY_COLS))


def verify_record(state, rep) -> dict:
    """One round of the verify cell on the host."""
    out = {f: getattr(state.stats, f).cpu().numpy()
           for f in ("m", "ysum", "ysq", "psum")}
    for f in ("offset", "closed", "raw_touched", "scan_m", "head", "round",
              "stopped", "t_io", "t_cpu", "cpu_bound"):
        out[f] = getattr(state, f).cpu().numpy()
    for f in ("estimate", "lo", "hi", "err", "decided", "tuples_round",
              "n_chunks", "m_tuples", "exhausted", "bytes_round"):
        out[f] = getattr(rep, f).cpu().numpy()
    return out


def verify_drive(step, state, packed, speeds, device, rounds: int,
                 eps=(), timed: bool = True) -> dict:
    """Rounds of one verify layout, each recorded.  With the queries'
    ``eps``: the round every query has stopped by (its HAVING verdict or
    its error ratio) and each query's first round at error ratio <= eps,
    recorded on until both are known and VERIFY_PARITY_ROUNDS have run.
    ``timed``: ms a round and collective ms a round over
    VERIFY_TIMED_ROUNDS more."""
    coll = step.coll
    reduce_ = coll._all_reduce
    spent = {"s": 0.0, "n": 0}

    def counted(t, op=None):
        t1 = time.perf_counter()
        out = reduce_(t, op)
        spent["s"] += time.perf_counter() - t1
        spent["n"] += 1
        return out

    coll._all_reduce = counted
    trace, stop, accurate = [], None, {}
    for r in range(rounds):
        state, rep = step(state, packed, speeds)
        trace.append(verify_record(state, rep))
        if not eps:
            continue
        if stop is None and bool(rep.all_stopped):
            stop = r + 1
        for q, (e, target) in enumerate(zip(trace[-1]["err"], eps)):
            if q not in accurate and e <= target:
                accurate[q] = r + 1
        if (stop is not None and len(accurate) == len(eps)
                and r + 1 >= VERIFY_PARITY_ROUNDS):
            break
    out = dict(trace=trace, stop=stop, accurate=accurate)
    if timed:
        sync(device)
        spent.update(s=0.0, n=0)
        t0 = time.perf_counter()
        for _ in range(VERIFY_TIMED_ROUNDS):
            state, rep = step(state, packed, speeds)
        sync(device)
        wall = time.perf_counter() - t0
        out.update(ms=wall / VERIFY_TIMED_ROUNDS * 1e3,
                   coll_ms=spent["s"] / VERIFY_TIMED_ROUNDS * 1e3,
                   collectives=spent["n"] / VERIFY_TIMED_ROUNDS)
    coll._all_reduce = reduce_
    return out


def verify_cell_rank(rank: int, ranks: int, init_file: str, out_dir: str,
                     packed_path: str, device: str) -> None:
    """One rank of [verify-cell]: the sharded layout (its N/D chunks) on
    ``device`` to every query's stop (VERIFY_PARITY_ROUNDS at least),
    timed, then the replicated layout (the whole store) for as many
    rounds, then (on the card) the sharded layout on the CPU over
    VERIFY_PARITY_ROUNDS rounds; peak device memory of each layout."""
    import pickle

    import torch.distributed as dist

    from repro_torch.launch.verify_cell import (
        build_verify_cell, local_state, production_verify_program)

    def program_on(dev):
        return production_verify_program(
            n_chunks=VERIFY_CHUNKS, m_per_chunk=VERIFY_M,
            num_cols=VERIFY_COLS, workers=ranks, budget=VERIFY_BUDGET,
            device=dev)[0]

    mesh = spmd_mesh(ranks, rank, init_file, device)
    card = device == "cuda"
    try:
        whole = np.load(packed_path, mmap_mode="r")
        nl = VERIFY_CHUNKS // ranks
        out = {}
        for layout in ("sharded", "replicated"):
            if card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            step, _, program = build_verify_cell(
                mesh, layout, VERIFY_BUDGET, program=program_on(device),
                device=device)
            rows = (whole[rank * nl:(rank + 1) * nl] if layout == "sharded"
                    else whole)
            reset_launches()
            packed = torch.from_numpy(np.array(rows)).to(device)
            speeds = torch.ones(program.config.num_workers // ranks,
                                device=device)
            state = local_state(program, rank,
                                program.config.num_workers // ranks)
            rounds = (VERIFY_ROUND_CAP if layout == "sharded"
                      else len(out["sharded"]["trace"]))
            run = verify_drive(step, state, packed, speeds, device, rounds,
                               eps=(program.eps.tolist()
                                    if layout == "sharded" else ()))
            run["packed_mib"] = packed.numel() / 2**20
            run["peak_mib"] = peak_mib(device)
            run["launches"] = launch_counts()["slot_extract"]
            out[layout] = run
            del packed, step, program, state
        if card:
            step, _, program = build_verify_cell(
                mesh, "sharded", VERIFY_BUDGET, program=program_on("cpu"),
                device="cpu")
            packed = torch.from_numpy(np.array(
                whole[rank * nl:(rank + 1) * nl]))
            out["cpu"] = verify_drive(
                step, local_state(program, rank, 1), packed,
                torch.ones(1), "cpu", VERIFY_PARITY_ROUNDS, timed=False)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def verify_close(got: dict, want: dict, where: str) -> None:
    for f in VERIFY_INTS:
        if not np.array_equal(np.asarray(got[f]).astype(np.int64),
                              np.asarray(want[f]).astype(np.int64)):
            raise AssertionError(f"{where}: {f} differs")
    for f in VERIFY_FLOATS:
        a = np.asarray(got[f], np.float64)
        b = np.asarray(want[f], np.float64)
        fin = np.isfinite(b)
        scale = max(float(np.max(np.abs(b[fin]), initial=0.0)), 1e-30)
        if not (np.array_equal(np.isfinite(a), fin) and np.max(
                np.abs(a[fin] - b[fin]), initial=0.0) <= 1e-5 * scale):
            raise AssertionError(f"{where}: {f} beyond float32 1e-5")


def phase_verify_cell(card: str, device: str = "cuda") -> dict:
    """launch/verify_cell.py over VERIFY_RANKS gloo ranks on the one card:
    the sharded layout to every query's stop (its state equal to the same
    ranks' on the CPU over the first rounds: integers equal, floats within
    float32 1e-5), the replicated layout bit for bit the single-device
    engine on the card, each verdict the float64 truth's and each estimate
    within 3 eps of its exact value; ms and collective ms a round and each
    rank's peak device memory for both layouts."""
    from repro_torch.launch.verify_cell import production_verify_program

    t0 = time.perf_counter()
    values = verify_values()
    program, cfg, codec = production_verify_program(
        n_chunks=VERIFY_CHUNKS, m_per_chunk=VERIFY_M, num_cols=VERIFY_COLS,
        workers=VERIFY_RANKS, budget=VERIFY_BUDGET, device=device)
    blocks = values.reshape(VERIFY_CHUNKS, VERIFY_M, VERIFY_COLS)
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        raw = np.stack(list(pool.map(codec.encode, blocks)))
    truth = [float(values[:, 1].mean()), float(values[:, 3].mean()),
             float(((values[:, 0] >= 0) & (values[:, 0] < 16)).sum())]
    verdicts = [truth[0] > 75.0, truth[1] < 10.0, truth[2] < 1e6]
    del values, blocks
    log(f"[verify-cell] {VERIFY_CHUNKS} chunks x {VERIFY_M} tuples x "
        f"{VERIFY_COLS} columns, {codec.record_bytes}-byte records "
        f"({raw.nbytes / 2**20:.0f} MiB raw) in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_verify_") as tmp:
        path = os.path.join(tmp, "packed.npy")
        np.save(path, raw)
        t0 = time.perf_counter()
        outs = spawn_ranks(verify_cell_rank, VERIFY_RANKS, (path, device),
                           "[verify-cell]")
        secs = time.perf_counter() - t0
    # the single-device engine: both workers on one device
    sharded = [o["sharded"] for o in outs]
    stop = sharded[0]["stop"]
    if stop is None:
        raise AssertionError(f"[verify-cell] a query still ran after "
                             f"{VERIFY_ROUND_CAP} rounds")
    packed = torch.from_numpy(raw).to(device)
    del raw
    speeds = torch.ones(VERIFY_RANKS, device=device)
    state = program.init_state()
    single = []
    for _ in range(len(sharded[0]["trace"])):
        state, rep = program.round_body(state, packed, speeds, VERIFY_BUDGET)
        single.append(verify_record(state, rep))
    del packed, state
    for rank, o in enumerate(outs):
        where = f"[verify-cell] rank {rank}"
        if o["sharded"]["stop"] != stop:
            raise AssertionError(f"{where}: stopped at round "
                                 f"{o['sharded']['stop']}, rank 0 at {stop}")
        for r, (g, w) in enumerate(zip(o["sharded"]["trace"],
                                       sharded[0]["trace"])):
            for f in w:
                if np.asarray(g[f]).tobytes() != np.asarray(w[f]).tobytes():
                    raise AssertionError(f"{where}: sharded round {r}: {f} "
                                         f"differs from rank 0's")
        rep_trace = o["replicated"]["trace"]
        if len(rep_trace) != len(single):
            raise AssertionError(f"{where}: {len(rep_trace)} replicated "
                                 f"rounds, single device {len(single)}")
        for r, (g, w) in enumerate(zip(rep_trace, single)):
            for f in w:
                a, b = np.asarray(g[f]), np.asarray(w[f])
                if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                    raise AssertionError(f"{where}: replicated round {r}: "
                                         f"{f} differs from the single "
                                         f"device's")
        rounds = len(rep_trace) + VERIFY_TIMED_ROUNDS
        if device == "cuda" and o["replicated"]["launches"] != rounds:
            raise AssertionError(f"{where}: kernel 1 launches "
                                 f"{o['replicated']['launches']} in the "
                                 f"replicated layout's {rounds} rounds")
        if device == "cuda":
            cpu = o["cpu"]["trace"]
            for r, (g, w) in enumerate(zip(o["sharded"]["trace"], cpu)):
                verify_close(g, w, f"{where}: round {r} card vs CPU")
    trace0 = sharded[0]["trace"]
    last = trace0[stop - 1]
    accurate = sharded[0]["accurate"]
    if len(accurate) != len(truth):
        raise AssertionError(f"[verify-cell] queries {sorted(accurate)} "
                             f"reached eps in {VERIFY_ROUND_CAP} rounds")
    estimates = []
    for q, (t, want) in enumerate(zip(truth, verdicts)):
        got = int(last["decided"][q])
        if got != int(want):
            raise AssertionError(f"[verify-cell] query {q}: verdict {got}, "
                                 f"the float64 truth's {int(want)}")
        est = float(trace0[accurate[q] - 1]["estimate"][q])
        estimates.append(est)
        if abs(est - t) > 3 * 0.05 * abs(t):
            raise AssertionError(f"[verify-cell] query {q}: estimate {est} "
                                 f"at error ratio <= eps beyond 3 eps of {t}")
    recorded = len(sharded[0]["trace"])
    parity = min(VERIFY_PARITY_ROUNDS, recorded)
    for layout in ("sharded", "replicated"):
        log(f"[verify-cell] {card}: {layout}: "
            + "; ".join(
                f"rank {r} {o[layout]['ms']:.3f} ms a round, collectives "
                f"{o[layout]['coll_ms']:.3f} ms a round "
                f"({o[layout]['collectives']:.1f} all_reduces), store "
                f"{o[layout]['packed_mib']:.0f} MiB, peak device memory "
                f"{o[layout]['peak_mib'] or 0:.1f} MiB"
                for r, o in enumerate(outs))
            + f" (over {VERIFY_TIMED_ROUNDS} rounds after the stop)")
    log(f"[verify-cell] {card}: every query stopped (decided or at eps) "
        f"after {stop} rounds on {VERIFY_RANKS} ranks x {VERIFY_BUDGET} "
        f"tuples, verdicts {[int(d) for d in last['decided']]} = the "
        f"truth's; error ratio <= eps after rounds "
        f"{[accurate[q] for q in range(len(truth))]} (cap "
        f"{VERIFY_ROUND_CAP}), estimates there "
        f"{[round(e, 4) for e in estimates]} vs exact "
        f"{[round(t, 4) for t in truth]}; the sharded "
        f"state equal on every rank and card == CPU (integers equal, floats "
        f"within float32 1e-5) over the first {parity} rounds; the "
        f"replicated layout bit for bit the single-device engine over "
        f"{recorded} rounds, kernel 1 launched once a round on each rank "
        f"({outs[0]['replicated']['launches']}); {secs:.1f} s with the "
        f"spawn")
    return dict(ranks=outs, stop=stop, seconds=secs)


# [shard]: smollm-135m's train_4k cell at its published widths (bf16,
# remat) on a (data 2, model 2) mesh of 4 gloo ranks on the one card, the
# batch cut from 256 x 4096 to 4 x 128; SHARD_STEPS steps, the first traced
# (3 until a proof on a slow host took 17.5 s a step there)
SHARD_ARCH = "smollm-135m"
SHARD_MESH = (2, 2)
SHARD_BATCH, SHARD_SEQ = 4, 128
SHARD_STEPS = 2
SHARD_PARITY_LAYERS = 4
# the decode cells' parity, each at its published widths, 4 layers,
# float32, B = 4, a 64-slot cache, 2 steps: qwen3-0.6b (8 KV heads: the
# cache over the heads on the model axis), smollm-135m (3 KV heads padded
# to 5: over T, the softmax split over the model ranks) and
# whisper-large-v3 (self- and cross-attention caches over the heads)
SHARD_DECODE_ARCHS = ("qwen3-0.6b", "smollm-135m", "whisper-large-v3")
SHARD_DECODE = dict(batch=4, seq=64, steps=2)


def shard_decode_spec():
    """SHARD_DECODE's shape and the overrides of [shard]'s decode cells:
    float32, SHARD_PARITY_LAYERS layers."""
    from repro_torch.configs.registry import ShapeSpec

    return (ShapeSpec("decode", SHARD_DECODE["seq"], SHARD_DECODE["batch"],
                      "decode"),
            dict(compute_dtype="float32", num_layers=SHARD_PARITY_LAYERS))


def shard_decode_parity(mesh, device, rank: int, reduced: bool) -> dict:
    """Each of SHARD_DECODE_ARCHS' decode cells (``shard_decode_spec``) on
    ``mesh`` over SHARD_DECODE's steps: by arch, the first step's
    collectives (``CommDebugMode``), the KV cache's placements and, on
    rank 0, the largest |logit difference| to the single-device decode
    (the same config on one device), relative to the largest |logit|
    (None on the other ranks)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.steps import build_cell, materialize, run_cell

    b, t = SHARD_DECODE["batch"], SHARD_DECODE["seq"]
    shape, overrides = shard_decode_spec()

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    out = {}
    for arch in SHARD_DECODE_ARCHS:
        cell = build_cell(arch, shape, mesh, reduced=reduced,
                          overrides=overrides)
        args, _ = materialize(cell, device, seed=0)
        (module, cache), cross = args[:2], args[4:]
        kv = cache["self"] if "self" in cache else cache
        layout = str(tuple(kv["k"].placements))
        single = build_model(cell.cfg, device=device, seed=0) if rank == 0 \
            else None
        cache1 = (single.init_cache(b, t, dtype=torch.float32) if single
                  else None)
        cross1 = [tuple(full(x) for x in c) for c in cross]
        rng = np.random.default_rng(1)
        worst, comm = 0.0, None
        for step in range(SHARD_DECODE["steps"]):
            toks = torch.as_tensor(rng.integers(0, cell.cfg.vocab_size,
                                                (b, 1)),
                                   dtype=torch.int32, device=device)
            pos = torch.full((b,), step, dtype=torch.int32, device=device)
            tok_d = distribute(toks, cell.args[2].sharding)
            pos_d = distribute(pos, cell.args[3].sharding)
            with CommDebugMode() as mode:
                lo, cache = run_cell(cell, module, cache, tok_d, pos_d,
                                     *cross)
            if comm is None:
                comm = {str(k): v for k, v in mode.get_comm_counts().items()}
            lo = full(lo)
            if single is not None:
                l1, cache1 = single.decode_step(cache1, toks, pos, *cross1)
                worst = max(worst, float((lo - l1).abs().max()
                                         / l1.abs().max()))
        out[arch] = dict(worst=worst if rank == 0 else None, comm=comm,
                         layout=layout)
        del module, cache, single, cache1, args, cross, cross1
        gc.collect()
    return out


def shard_rank(rank: int, ranks: int, init_file: str, out_dir: str,
               device: str, reduced: bool) -> None:
    """One rank of [shard]: the float32 parity step at
    SHARD_PARITY_LAYERS layers (rank 0 also runs the single-device step on
    its device), then the full-width cell: a traced step (collectives,
    the residual stream's layout at each ``constrain("btd")``, before and
    after it) and timed ones; the seconds of each part."""
    import datetime
    import pickle

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell, materialize, run_cell
    from repro_torch.models import transformer
    from repro_torch.models.convert import tree_from_module

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=ranks,
        timeout=datetime.timedelta(seconds=SPMD_PG_TIMEOUT_S))
    try:
        mesh = make_debug_mesh(*SHARD_MESH, device_type=device)
        shape = ShapeSpec("train_4k", SHARD_SEQ, SHARD_BATCH, "train")

        def full(t):
            return (t.full_tensor() if isinstance(t, DTensor) else t
                    ).detach().to(torch.float64)

        out, secs = {}, {}
        t0 = time.perf_counter()
        # 1. parity: float32 at SHARD_PARITY_LAYERS layers
        cell = build_cell(SHARD_ARCH, shape, mesh, reduced=reduced,
                          overrides=dict(compute_dtype="float32",
                                         num_layers=SHARD_PARITY_LAYERS))
        (state, batch), model = materialize(cell, device, seed=0)
        new, m = run_cell(cell, state, batch)
        got = dict(loss=full(m["loss"]), gnorm=full(m["grad_norm"]),
                   params=[full(v) for v in leaves(new.params)],
                   mu=[full(v) for v in leaves(new.opt.mu)])
        b1 = {k: full(v).to(torch.int32).to(device)
              for k, v in batch.items()}
        del new, state
        if rank == 0:
            st1 = init_train_state(tree_from_module(model))
            new1, m1 = cell.fn(st1, b1)

            def worst(a_leaves, b_leaves):
                return max(float((a - b.double()).norm()
                                 / max(float(b.double().norm()), 1e-30))
                           for a, b in zip(a_leaves, b_leaves))

            out["parity"] = dict(
                loss=abs(float(got["loss"] - m1["loss"].double()))
                / abs(float(m1["loss"])),
                gnorm=abs(float(got["gnorm"] - m1["grad_norm"].double()))
                / abs(float(m1["grad_norm"])),
                params=worst(got["params"], leaves(new1.params)),
                mu=worst(got["mu"], leaves(new1.opt.mu)))
            del new1, st1
        del model, got, batch, b1
        secs["parity"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["decode"] = shard_decode_parity(mesh, device, rank, reduced)
        secs["decode"] = time.perf_counter() - t0
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # 2. the full-width cell
        t0 = time.perf_counter()
        cell = build_cell(SHARD_ARCH, shape, mesh, reduced=reduced)
        (state, batch), model = materialize(cell, device, seed=0)
        del model
        secs["build"] = time.perf_counter() - t0
        resident = sum(t.to_local().numel() * t.to_local().element_size()
                       for t in leaves(state) if isinstance(t, DTensor))
        whole = sum(t.numel() * t.element_size() for t in leaves(state))
        # each constrain("btd"): the layout it was given, and its own
        seen = []
        real = transformer.constrain

        def recording(x, kind):
            y = real(x, kind)
            if kind == "btd":
                seen.append((tuple(x.placements), tuple(y.placements)))
            return y

        transformer.constrain = recording
        # each step's own high-water mark above what is allocated before
        # it (the first from here, past materialization)
        mark = step_mark(device)
        t0 = time.perf_counter()
        try:
            with CommDebugMode() as comm:
                state, m = run_cell(cell, state, batch)
                sync(device)
        finally:
            transformer.constrain = real
        secs["traced"] = time.perf_counter() - t0
        step_bytes = [step_high(device, mark)]
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        losses = [float(full(m["loss"]))]
        sync(device)
        mark2 = step_mark(device)
        t0 = time.perf_counter()
        for _ in range(SHARD_STEPS - 1):
            state, m = run_cell(cell, state, batch)
            losses.append(float(full(m["loss"])))
        sync(device)
        ms = (time.perf_counter() - t0) / (SHARD_STEPS - 1) * 1e3
        step_bytes.append(step_high(device, mark2))
        # the peak since before materialization, as before the marks
        peak = (None if mark is None else
                max(mark[1], mark2[1], torch.cuda.max_memory_allocated())
                / 2**20)
        out.update(
            ms=ms, losses=losses, comm=counts, btd=seen, secs=secs,
            resident=resident, resident_mib=resident / 2**20,
            whole_mib=whole / 2**20, peak_mib=peak,
            allocated_before=None if mark is None else mark[0],
            step_bytes=step_bytes,
            layers=cell.cfg.num_layers, dtype=cell.cfg.compute_dtype,
            remat=cell.cfg.remat, d_model=cell.cfg.d_model,
            vocab=cell.cfg.vocab_size)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def phase_shard(card: str, device: str = "cuda",
                reduced: bool = False) -> dict:
    """smollm-135m's train_4k cell built by ``build_cell`` on a (data 2,
    model 2) debug mesh of 4 gloo ranks: the float32 step at
    SHARD_PARITY_LAYERS layers equal to the single-device step on the card
    (loss, grad_norm, the updated parameters and Adam's first moment
    within 1e-5 relative, each leaf in norm: at the first step the moment
    is the leaf's scaled gradient), every block's output reaching
    ``constrain("btd")`` batch-sharded over data on a traced step, and each
    of SHARD_DECODE_ARCHS' decode cells equal to single-device decode
    within 1e-5 of the largest logit; ms a step, collectives a step, each
    rank's peak memory and resident state."""
    ranks = SHARD_MESH[0] * SHARD_MESH[1]
    t0 = time.perf_counter()
    outs = spawn_ranks(shard_rank, ranks, (device, reduced), "[shard]")
    secs = time.perf_counter() - t0
    par = outs[0]["parity"]
    if not all(par[k] <= 1e-5 for k in ("loss", "gnorm", "params", "mu")):
        raise AssertionError(f"[shard] the {SHARD_PARITY_LAYERS}-layer "
                             f"float32 step differs from the single-device "
                             f"step: {par}")
    for arch, dec in outs[0]["decode"].items():
        if not dec["worst"] <= 1e-5:
            raise AssertionError(f"[shard] the {arch} decode cell differs "
                                 f"from single-device decode: "
                                 f"{dec['worst']} of the largest logit")
    from torch.distributed.tensor import Replicate, Shard

    # the first constrain("btd") takes the embedding's output, each later
    # one a block's: a block must hand its output on batch-sharded over
    # data (mesh dim 0); a gather of the activations there would be the
    # failure constrain exists to stop, and constrain would hide it
    want = (Shard(0), Replicate())
    for rank, o in enumerate(outs):
        blocks = o["btd"][1:]
        if len(o["btd"]) != o["layers"] + 1:
            raise AssertionError(f"[shard] rank {rank}: {len(o['btd'])} "
                                 f"constrain('btd') calls in a step of "
                                 f"{o['layers']} layers")
        bad = [i for i, (given, kept) in enumerate(blocks, 1)
               if given[0] != Shard(0) or kept != want]
        if bad:
            raise AssertionError(f"[shard] rank {rank}: the residual stream "
                                 f"left its batch layout at blocks {bad}: "
                                 f"{[o['btd'][i] for i in bad]}")
        if not all(np.isfinite(o["losses"])):
            raise AssertionError(f"[shard] rank {rank}: losses "
                                 f"{o['losses']}")
        if o["losses"] != outs[0]["losses"]:
            raise AssertionError(f"[shard] rank {rank}: losses differ from "
                                 f"rank 0's")
    o = outs[0]
    given = sorted({str(g) for g, _ in o["btd"][1:]})
    log(f"[shard] {card}: {SHARD_ARCH} train_4k on a (data "
        f"{SHARD_MESH[0]}, model {SHARD_MESH[1]}) mesh of {ranks} gloo "
        f"ranks: {o['layers']} layers, d_model {o['d_model']}, vocab "
        f"{o['vocab']}, {o['dtype']}, remat {o['remat']}, batch "
        f"{SHARD_BATCH} x {SHARD_SEQ}; the {SHARD_PARITY_LAYERS}-layer "
        f"float32 step == the single-device step on the card (loss "
        f"{par['loss']:.2e}, grad_norm {par['gnorm']:.2e}, parameters "
        f"{par['params']:.2e}, first moments {par['mu']:.2e} relative); "
        f"the decode cells ({SHARD_PARITY_LAYERS} layers, float32, B = "
        f"{SHARD_DECODE['batch']}, {SHARD_DECODE['seq']} slots, "
        f"{SHARD_DECODE['steps']} steps) == single-device decode within "
        + ", ".join(f"{a} {d['worst']:.2e} (cache {d['layout']})"
                    for a, d in outs[0]["decode"].items())
        + f" of the largest logit; every block's output batch over data at "
        f"constrain('btd') (given {given}, "
        f"the embedding's {o['btd'][0][0]}; "
        f"{sum(g != k for g, k in o['btd'])} of {len(o['btd'])} calls "
        f"redistributed); losses "
        f"{[round(x, 4) for x in o['losses']]}; "
        f"{o['ms']:.1f} ms a step (the untraced steps); collectives of "
        f"the first step {o['comm']}")

    def mib(b):
        return "not measured" if b is None else f"{b / 2**20:.1f}"

    log(f"[shard] {card}: per rank resident state "
        + ", ".join(f"{x['resident_mib']:.1f}" for x in outs)
        + f" MiB of {o['whole_mib']:.1f} MiB whole; peak device memory "
        + ", ".join(f"{x['peak_mib'] or 0:.1f}" for x in outs)
        + " MiB (materialization included); allocated before the first "
        + "step " + ", ".join(mib(x["allocated_before"]) for x in outs)
        + " MiB; each step's own high-water mark above what was allocated "
        + "before it, steps 1 and 2: "
        + ", ".join("/".join(mib(b) for b in x["step_bytes"]) for x in outs)
        + f" MiB; {secs:.1f} s with the spawn (rank 0's seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in o["secs"].items())
        + ")")
    return dict(ranks=outs, seconds=secs)


# ---------------------------------------------------------------- dry run ----
# launch/dryrun.py's records on fake process groups (meta DTensors: no
# card, no memory), one spawned process: smollm-135m's train_4k cell at
# full width on the 16 x 16 production mesh, [shard]'s own cell on its
# (data 2, model 2) mesh, [train]'s step on one rank; and [train]'s plain
# step (train_step_ms's program, no mesh) walked on meta for its memory
DRYRUN_PRODUCTION = dict(arch=SHARD_ARCH, shape="train_4k", ranks=256)
# cached decode on the production mesh: each rank attends over its own
# block of the KV cache, and no all-gather moves the cache
DRYRUN_DECODE = dict(arch="qwen3-0.6b", shape="decode_32k", ranks=256)
# the production rank's matmul FLOPs a step at most: its share of the
# model's (heads split 16 ways, the K/V projections replicated, remat's
# second forward) is ~1.7e13
DRYRUN_PRODUCTION_FLOPS = 2.5e13
COMM_KINDS = {"all_gather_into_tensor": "all-gather",
              "_allgather_base_": "all-gather",
              "all_reduce": "all-reduce",
              "reduce_scatter_tensor": "reduce-scatter",
              "all_to_all_single": "all-to-all",
              "shard_dim_alltoall": "all-to-all"}


def comm_kinds(counts: dict) -> dict:
    """``CommDebugMode``'s counts (keyed by op) by collective kind."""
    out: dict = {}
    for op, n in counts.items():
        name = str(op).rsplit(".", 1)[-1]
        kind = COMM_KINDS.get(name, name)
        out[kind] = out.get(kind, 0) + n
    return out


def dryrun_proc(rank: int, ranks: int, init_file: str, out_dir: str) -> None:
    """[dryrun]'s process: the records, each on its own fake group (the
    decode cells of [shard] on one), and the seconds of each."""
    import pickle

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh

    decode_shape, decode_overrides = shard_decode_spec()
    cells = (
        ("production", DRYRUN_PRODUCTION["arch"], DRYRUN_PRODUCTION["ranks"],
         None, DRYRUN_PRODUCTION["shape"], None),
        ("decode", DRYRUN_DECODE["arch"], DRYRUN_DECODE["ranks"], None,
         DRYRUN_DECODE["shape"], None),
        ("shard", SHARD_ARCH, SHARD_MESH[0] * SHARD_MESH[1], SHARD_MESH,
         ShapeSpec("train_4k", SHARD_SEQ, SHARD_BATCH, "train"), None),
        ("shard_decode", SHARD_DECODE_ARCHS, SHARD_MESH[0] * SHARD_MESH[1],
         SHARD_MESH, decode_shape, decode_overrides),
        ("train", TRAIN_ARCH, 1, (1, 1),
         ShapeSpec("train_4k", TRAIN["seq_len"], TRAIN["batch"], "train"),
         None))
    out, secs = {}, {}
    for name, archs, world, mesh_shape, shape, overrides in cells:
        t0 = time.perf_counter()
        with dryrun.fake_group(world):
            mesh = (make_debug_mesh(*mesh_shape, device_type="cpu")
                    if mesh_shape else None)
            recs = {arch: dryrun.run_cell(arch, shape, mesh=mesh,
                                          overrides=overrides)
                    for arch in ((archs,) if isinstance(archs, str)
                                 else archs)}
        # [shard]'s decode cells by arch, every other record alone
        out[name] = recs if isinstance(archs, tuple) else recs[archs]
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train_plain"] = train_step_walk()
    secs["train_plain"] = time.perf_counter() - t0
    out["secs"] = secs
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def train_step_walk() -> dict:
    """[train]'s step as ``train_step_ms`` runs it, walked on the meta
    device with the CUDA caching allocator's granule: the walk's memory
    (``DispatchWalk.memory``), the state and the batch held."""
    from repro_torch.roofline.dispatch_walk import (
        CUDA_ALLOC_GRANULE, DispatchWalk)

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device="meta", seed=ML_SEED)
    state = init_train_state(tree_from_module(model))
    step = make_train_step(model.loss_fn, AdamWConfig())
    batch = {k: torch.empty((TRAIN["batch"], TRAIN["seq_len"]),
                            dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with DispatchWalk(hold=(state, batch),
                      granule=CUDA_ALLOC_GRANULE) as w:
        step(state, batch)
    return w.memory()


def train_step_ms(device: str = "cuda") -> tuple:
    """[train]'s step (TRAIN_ARCH at its published widths, TRAIN's batch,
    ``make_train_step`` as ``Trainer`` builds it) from its initial state:
    the median ms of TRAIN_TIME_REPS steps, and the steps' own high-water
    mark in bytes above what is allocated before them (after one step
    that warms the process up)."""
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=device, seed=ML_SEED)
    box = [init_train_state(tree_from_module(model))]
    step = make_train_step(model.loss_fn, AdamWConfig())
    batch = {k: v.to(device) for k, v in token_batches(
        cfg, 1, (TRAIN["batch"], TRAIN["seq_len"]), seed=1)[0].items()}

    def one():
        box[0], _ = step(box[0], batch)

    one()
    mark = step_mark(device)
    ms = median_ms(one, TRAIN_TIME_REPS, device)
    return ms, step_high(device, mark)


# the walk's temp_bytes against a step's measured high-water mark
DRYRUN_MEMORY_TOL = 0.10


def memory_gaps(tag: str, predicted: int, measured: list) -> list:
    """``(predicted - measured) / measured`` for each rank's measured
    step high-water mark; raises if one is past DRYRUN_MEMORY_TOL."""
    gaps = [(predicted - m) / m for m in measured]
    bad = [r for r, g in enumerate(gaps) if abs(g) > DRYRUN_MEMORY_TOL]
    if bad:
        raise AssertionError(
            f"[dryrun] {tag}: the walk's temp_bytes {predicted} B against "
            f"the measured step high-water marks {measured} B: ranks {bad} "
            f"past {DRYRUN_MEMORY_TOL:.0%}")
    return gaps


def phase_dryrun(card: str, shard: dict, train_ms: float,
                 train_bytes: int) -> dict:
    """launch/dryrun.py's records (``dryrun_proc``): each priced with
    roofline/hw.py's H100 constants, finite; [shard]'s cell's state bytes
    a rank, from its layouts, equal to ``shard``'s measured resident bytes
    on every rank, and its collectives by kind equal to ``shard``'s first
    step's; [train]'s step's roofline bound at or below ``train_ms``, its
    measured median.  Memory: [shard]'s cell's ``temp_bytes`` within
    DRYRUN_MEMORY_TOL of each rank's first step's own high-water mark, and
    the walk of [train]'s plain step within it of ``train_bytes``, that
    step's measured mark; the production record's peak a rank, modeled.
    Cached decode: DRYRUN_DECODE's record and [shard]'s decode cells move
    no block of the KV cache in an all-gather, and each of [shard]'s
    decode cells has the collectives by kind of its first step there."""
    t0 = time.perf_counter()
    out = spawn_ranks(dryrun_proc, 1, (), "[dryrun]")[0]
    secs = time.perf_counter() - t0
    prod, cell, one = out["production"], out["shard"], out["train"]
    decode, shard_decode = out["decode"], out["shard_decode"]
    # cached decode: finite terms, the peak from the walk, and no
    # all-gather that moves a block of the KV cache
    for tag, rec in (("decode", decode), *shard_decode.items()):
        rf, mem = rec["roofline"], rec["memory"]
        terms = [rf[k] for k in ("compute_s", "memory_s", "collective_s")]
        if not (np.all(np.isfinite(terms)) and rf["hlo_flops_per_chip"] > 0
                and mem["peak_bytes"] == mem["argument_bytes"]
                + mem["temp_bytes"]
                and rec["kv_cache_gather_bytes"] == 0):
            raise AssertionError(f"[dryrun] {tag} decode: roofline {rf}, "
                                 f"memory {mem}, KV-cache all-gathers "
                                 f"{rec['kv_cache_gather_bytes']} B")
    for arch, rec in shard_decode.items():
        got = comm_kinds(shard["ranks"][0]["decode"][arch]["comm"])
        if rec["collective_counts"] != got:
            raise AssertionError(f"[dryrun] [shard]'s {arch} decode cell: "
                                 f"collectives {rec['collective_counts']} "
                                 f"in the walk, {got} in [shard]'s first "
                                 f"decode step")
    for tag, rec in (("production", prod), ("shard", cell), ("train", one)):
        rf = rec["roofline"]
        terms = [rf[k] for k in ("compute_s", "memory_s", "collective_s")]
        if not (np.all(np.isfinite(terms)) and rf["hlo_flops_per_chip"] > 0
                and rf["hlo_bytes_per_chip"] > 0):
            raise AssertionError(f"[dryrun] {tag}: roofline {rf}")
        mem = rec["memory"]
        # the train state is donated: the step's own bytes hold at least
        # its outputs that alias no argument, and the outputs alias all
        # of the state
        fresh = mem["output_bytes"] - mem["alias_bytes"]
        if not (mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
                and mem["temp_bytes"] >= fresh > 0
                and mem["alias_bytes"] == mem["state_bytes_by_rank"][0][0]
                and rec["flops"] == rf["hlo_flops_per_chip"]):
            raise AssertionError(f"[dryrun] {tag}: memory {mem}, flops "
                                 f"{rec['flops']}")
    want_mesh = {"data": 16, "model": 16}
    if prod["chips"] != DRYRUN_PRODUCTION["ranks"] or prod["mesh"] != \
            want_mesh:
        raise AssertionError(f"[dryrun] production cell on {prod['mesh']}")
    # the production rank fits an H100 and does its share of the work:
    # the donated state, the vocab-parallel loss and the query heads split
    # over the model axis
    if not (prod["memory"]["peak_bytes"] < H100_SXM.hbm_bytes
            and prod["flops"] < DRYRUN_PRODUCTION_FLOPS):
        raise AssertionError(
            f"[dryrun] production cell: peak {prod['memory']['peak_bytes']}"
            f" B a rank (the H100's {H100_SXM.hbm_bytes:.0f}), matmul FLOPs "
            f"{prod['flops']:.6g} a rank (gate "
            f"{DRYRUN_PRODUCTION_FLOPS:.6g})")
    predicted = [n for n, k in cell["memory"]["state_bytes_by_rank"]
                 for _ in range(k)]
    measured = [o["resident"] for o in shard["ranks"]]
    if predicted != measured:
        raise AssertionError(f"[dryrun] [shard]'s cell: state bytes a rank "
                             f"{predicted} from the layouts, {measured} "
                             f"resident in [shard]")
    shard_comm = comm_kinds(shard["ranks"][0]["comm"])
    if cell["collective_counts"] != shard_comm:
        raise AssertionError(f"[dryrun] [shard]'s cell: collectives "
                             f"{cell['collective_counts']} in the walk, "
                             f"{shard_comm} in [shard]'s first step")
    bound_ms = one["roofline"]["bound_s"] * 1e3
    if not bound_ms <= train_ms:
        raise AssertionError(f"[dryrun] [train]'s roofline bound "
                             f"{bound_ms:.3f} ms exceeds its measured step "
                             f"{train_ms:.3f} ms")
    shard_pred = cell["memory"]["temp_bytes"]
    shard_meas = [o["step_bytes"][0] for o in shard["ranks"]]
    shard_gaps = memory_gaps("[shard]'s cell", shard_pred, shard_meas)
    plain = out["train_plain"]
    train_gap = memory_gaps("[train]'s step", plain["temp_peak_bytes"],
                            [train_bytes])[0]

    def mib(b):
        return f"{b / 2**20:.1f}"

    def terms(rec):
        rf = rec["roofline"]
        return (f"compute {rf['compute_s'] * 1e3:.3f} ms, memory "
                f"{rf['memory_s'] * 1e3:.3f} ms, collectives "
                f"{rf['collective_s'] * 1e3:.3f} ms ({rf['dominant']} "
                f"dominant); matmul FLOPs a rank "
                f"{rf['hlo_flops_per_chip']:.6g} in {rf['dot_count']} ops, "
                f"HBM bytes a rank {rf['hlo_bytes_per_chip']:.6g}; model "
                f"FLOPs {rf['model_flops']:.6g}, useful "
                f"{rf['useful_flops_ratio']:.6g}, roofline fraction "
                f"{rf['roofline_fraction']:.6g}")

    rf = prod["roofline"]
    log(f"[dryrun] modeled with the H100's constants (roofline/hw.py: "
        f"{H100_SXM.name}), not measured; records on fake process groups, "
        f"meta DTensors")
    log(f"[dryrun] {prod['arch']} {prod['shape']} at full width on the "
        f"{prod['mesh']} mesh of {prod['chips']} fake ranks: built in "
        f"{prod['lower_s']} s, step walked in {prod['compile_s']} s; "
        f"arguments {prod['memory']['argument_bytes']} B a rank (state "
        f"{prod['memory']['state_bytes_by_rank']}); collectives "
        f"{prod['collective_counts']}, NVLink "
        f"{rf['collective_detail']['nvlink_bytes']:.6g} B, inter-node "
        f"{rf['collective_detail']['inter_node_bytes']:.6g} B; {terms(prod)}")
    log(f"[dryrun] [shard]'s cell (batch {SHARD_BATCH} x {SHARD_SEQ} on "
        f"{cell['mesh']}): state bytes a rank from the layouts {predicted} "
        f"== [shard]'s resident bytes {measured}; collectives a step "
        f"{cell['collective_counts']} (the walk, on a CPU-typed mesh) == "
        f"[shard]'s first step's {shard_comm} (CommDebugMode, the card's "
        f"gloo mesh); {terms(cell)}")
    log(f"[dryrun] {card}: [train]'s step (batch {TRAIN['batch']} x "
        f"{TRAIN['seq_len']}, one rank): roofline bound {bound_ms:.3f} ms "
        f"<= measured median {train_ms:.3f} ms (fraction "
        f"{bound_ms / train_ms:.4f}); {terms(one)}")
    log(f"[dryrun] {card}: memory, the walk's temp_bytes (512 B granule) "
        f"against each step's measured own high-water mark above what was "
        f"allocated before it (gate {DRYRUN_MEMORY_TOL:.0%}): [shard]'s "
        f"cell, ranks 0-{len(shard_meas) - 1}: predicted {mib(shard_pred)} "
        f"MiB ({shard_pred} B), measured "
        + ", ".join(f"{mib(m)}" for m in shard_meas) + " MiB, gap "
        + ", ".join(f"{mib(shard_pred - m)} MiB ({100 * g:+.2f}%)"
                    for m, g in zip(shard_meas, shard_gaps))
        + "; second step measured "
        + ", ".join(mib(o["step_bytes"][1]) for o in shard["ranks"])
        + f" MiB; the record's peak a rank {mib(cell['memory']['peak_bytes'])}"
        f" MiB.  [train]'s plain step walked on meta: predicted "
        f"{mib(plain['temp_peak_bytes'])} MiB ({plain['temp_peak_bytes']} B,"
        f" at op {plain['peak_index']} of {plain['ops']}, "
        f"{plain['peak_op']}), measured {mib(train_bytes)} MiB, gap "
        f"{mib(plain['temp_peak_bytes'] - train_bytes)} MiB "
        f"({100 * train_gap:+.2f}%); the (1, 1) record's temp "
        f"{mib(one['memory']['temp_bytes'])} MiB")
    peak = prod["memory"]["peak_bytes"]
    log(f"[dryrun] modeled, not measured: {prod['arch']} {prod['shape']} on "
        f"{prod['chips']} ranks: peak a rank {mib(peak)} MiB ({peak} B; "
        f"arguments "
        f"{prod['memory']['argument_bytes']} B, the step's own "
        f"{prod['memory']['temp_bytes']} B, outputs "
        f"{prod['memory']['output_bytes']} B of which "
        f"{prod['memory']['alias_bytes']} B alias the donated state) below "
        f"the H100's {H100_SXM.hbm_bytes:.0f} B; matmul FLOPs a rank "
        f"{prod['flops']:.6g} below {DRYRUN_PRODUCTION_FLOPS:.6g}, useful "
        f"ratio {rf['useful_flops_ratio']:.6g}")
    rf = decode["roofline"]
    log(f"[dryrun] modeled, not measured: {decode['arch']} "
        f"{decode['shape']} on {decode['chips']} ranks {decode['mesh']}: "
        f"all-gathers of KV-cache blocks {decode['kv_cache_gather_bytes']} "
        f"B a rank (gate 0); collectives {decode['collective_counts']}, "
        f"{rf['collective_detail']['inter_node_bytes']:.6g} B inter-node; "
        f"peak a rank {mib(decode['memory']['peak_bytes'])} MiB; "
        f"{terms(decode)}")
    log(f"[dryrun] [shard]'s decode cells on {SHARD_MESH}: collectives a "
        f"step (the walk) == [shard]'s first decode step's (CommDebugMode): "
        + "; ".join(f"{a} {r['collective_counts']}, KV-cache all-gathers "
                    f"{r['kv_cache_gather_bytes']} B"
                    for a, r in shard_decode.items()))
    log(f"[dryrun] {secs:.1f} s with the spawn (cells: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["secs"].items()) + ")")
    return dict(records=out, seconds=secs, bound_ms=bound_ms,
                shard_gaps=shard_gaps, train_gap=train_gap)


def shard_phases(card: str, device: str = "cuda") -> dict:
    """[verify-cell] and [shard], each with its seconds."""
    t0 = time.perf_counter()
    vc = phase_verify_cell(card, device)
    t1 = time.perf_counter()
    sh = phase_shard(card, device)
    t2 = time.perf_counter()
    log(f"[shard] phase seconds: [verify-cell] {t1 - t0:.1f}, [shard] "
        f"{t2 - t1:.1f}")
    return dict(verify=vc, shard=sh)


def ml_phases(card: str) -> dict:
    """The ML plane's phases in order, each with its seconds."""
    out, secs = {}, {}
    for name, fn in (("models", lambda: phase_models(card)),
                     ("serve", lambda: phase_serve(card)),
                     ("ola-eval", lambda: phase_ola_eval(card)),
                     ("ingest", phase_ingest),
                     ("train", lambda: phase_train(card)),
                     ("families", lambda: phase_families(card)),
                     ("families-train", lambda: phase_families_train(card)),
                     ("examples", phase_examples)):
        t0 = time.perf_counter()
        out[name] = fn()
        gc.collect()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    log("[ml] phase seconds: "
        + ", ".join(f"[{k}] {v:.1f}" for k, v in secs.items())
        + f"; {sum(secs.values()):.1f} in all")
    out["secs"] = secs
    return out


# ---------------------------------------------------------------- main ----
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build, kernel checks and kernel times only")
    ap.add_argument("--spmd", action="store_true",
                    help="build, the rank-width kernel checks, the packed "
                         "deployment and the multi-rank phases only")
    ap.add_argument("--ml", action="store_true",
                    help="build and the ML plane's phases only")
    ap.add_argument("--train", action="store_true",
                    help="build and the training phase only")
    ap.add_argument("--families", action="store_true",
                    help="build and the other model families' phases only")
    ap.add_argument("--shard", action="store_true",
                    help="build, the sharded verify cell and the sharded "
                         "train step only")
    ap.add_argument("--dryrun", action="store_true",
                    help="build, the sharded train step, a train step's "
                         "time and the dry run only")
    args = ap.parse_args(argv)
    kernels_only = args.kernels
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke runs on the GPU only", file=sys.stderr)
        return 2
    # the plain versions run on the card too: keep float32 products in
    # full float32 (no TF32 matmul or convolution path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    log(f"[device] {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    phase_build()
    if args.dryrun:
        sh = phase_shard(card)
        ms, step_bytes = train_step_ms()
        log(f"[dryrun] {card}: [train]'s step from its initial state "
            f"{ms:.3f} ms (median of {TRAIN_TIME_REPS}), its own high-water "
            f"mark {step_bytes} B")
        phase_dryrun(card, sh, ms, step_bytes)
        log("[done] --dryrun: build, [shard] and [dryrun] passed")
        return 0
    if args.shard:
        shard_phases(card)
        log("[done] --shard: build, [verify-cell] and [shard] passed")
        return 0
    if args.train:
        t0 = time.perf_counter()
        phase_train(card)
        log(f"[done] --train: build and [train] passed; [train] "
            f"{time.perf_counter() - t0:.1f} s")
        return 0
    if args.families:
        t0 = time.perf_counter()
        phase_families(card)
        t1 = time.perf_counter()
        phase_families_train(card)
        log(f"[done] --families: build, [families] ({t1 - t0:.1f} s) and "
            f"[families-train] ({time.perf_counter() - t1:.1f} s) passed")
        return 0
    if args.ml:
        ml_phases(card)
        log("[done] --ml: build and the ML plane's phases passed")
        return 0

    t0 = time.perf_counter()
    values, store = build_store(NUM_TUPLES, NUM_CHUNKS, NUM_COLS)
    log(f"[data] {store.num_tuples} tuples x {NUM_COLS} columns, "
        f"{store.num_chunks} chunks, {store.codec.record_bytes}-byte ASCII "
        f"records ({store.num_tuples * store.codec.record_bytes / 2**30:.2f}"
        f" GiB) generated and encoded in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, gstore = build_wiki_store(GROUP_TUPLES, GROUP_CHUNKS, GROUP_LANGS)
    log(f"[data] grouped kernels' table: {gstore.num_tuples} wiki-like "
        f"tuples ({GROUP_LANGS} languages) x 4 columns, {gstore.num_chunks} "
        f"uneven "
        f"chunks, {gstore.codec.record_bytes}-byte records "
        f"({gstore.num_tuples * gstore.codec.record_bytes / 2**20:.1f} MiB) "
        f"in {time.perf_counter() - t0:.1f} s")

    packed, sizes = store.packed_device_view("cuda")
    if args.spmd:
        lpacked, lsizes = lang_store_packed()
        phase_rank_widths(packed, np.asarray(sizes), lpacked, lsizes)
        del packed, lpacked
        srv = phase_server(store, values)
        phase_spmd_parity()
        phase_spmd(store, values, srv, card)
        log("[done] --spmd: build, rank-width checks, the packed deployment "
            "and the multi-rank phases passed")
        return 0
    checks = phase_kernel(packed, sizes)
    stream_checks = phase_stream_kernels(packed, sizes)
    gpacked, gsizes = gstore.packed_device_view("cuda")
    gsizes = np.asarray(gsizes)
    lpacked, lsizes = lang_store_packed()
    gchecks = phase_grouped_kernels(gpacked, gsizes, lpacked, lsizes)
    phase_rank_widths(packed, np.asarray(sizes), lpacked, lsizes)
    del lpacked
    rows = phase_rows_kernels(packed, np.asarray(sizes), values)
    if kernels_only:
        sizes = np.asarray(sizes)
        report_times(card, phase_times(packed, sizes, [8, 4096], None),
                     phase_stream_times(packed, sizes),
                     phase_grouped_times(gpacked, gsizes, packed, sizes, rows),
                     None, None)
        log("[done] --kernels: build, kernel checks and times passed")
        return 0
    del packed
    srv = phase_server(store, values)
    launches = srv["launches"]
    phase_parity()
    phase_stream_parity()
    # the kernel times hold each kernel to a whole count of device kernels
    # per call, which the profiler keeps exact only early in a process:
    # later in a long one, its traces lose ever more kernel launches
    # (TRACE_LOSS), so they run before the serving-plane phases
    times = phase_times(srv["packed"], srv["sizes"], srv["rungs"],
                        srv["wall_s"])
    stimes = phase_stream_times(srv["packed"], srv["sizes"])
    gtimes = phase_grouped_times(gpacked, gsizes, srv["packed"],
                                 srv["sizes"], rows)
    ptf = phase_ptf()
    phase_sched_parity()
    sched = phase_sched(store, values, srv["packed"])
    rollup = phase_rollup(store, values, srv["packed"])
    t0 = time.perf_counter()
    phase_spmd_parity()
    spmd = phase_spmd(store, values, srv, card)
    spmd_s = time.perf_counter() - t0
    rows_run = {k: v for k, v in rows.items() if k not in ("plan", "sizes_t")}
    del rows
    packed_run = {k: srv[k] for k in ("results", "rounds", "peak", "wall_s",
                                      "cut")}
    del srv
    # the serving-plane phases' servers sit in reference cycles (metrics
    # gauges close over them) holding the packed store: collect them before
    # the stream deployment measures its peak
    gc.collect()
    torch.cuda.empty_cache()
    dep = phase_stream_deployment(store, values, packed_run)
    phase_profile(store, values, PROFILE_ROUNDS)
    del values
    torch.cuda.empty_cache()
    phase_grouped_parity()
    del gstore, gpacked
    dvalues, dstore = build_wiki_store(GROUP_DEPLOY_TUPLES, GROUP_CHUNKS,
                                       GROUP_LANGS)
    log(f"[data] grouped deployment: {dstore.num_tuples} wiki-like tuples, "
        f"{dstore.num_chunks} uneven chunks, {GROUP_QUERIES} grouped queries")
    gdep = phase_grouped_deployment(dvalues, dstore)
    with run_grouped_server(dstore, "cuda") as server:
        profile_rounds(server, PROFILE_ROUNDS, "grouped")
    del dstore, dvalues
    gc.collect()
    torch.cuda.empty_cache()
    ml = ml_phases(card)
    gc.collect()
    torch.cuda.empty_cache()
    shard = shard_phases(card)
    phase_dryrun(card, shard["shard"], ml["train"]["step_ms"],
                 ml["train"]["step_bytes"])

    report_times(card, times, stimes, gtimes, dep, gdep)
    log(f"[times] {card}: serving plane: [ptf] ASCII chain {ptf['rounds']} "
        f"rounds, {ptf['wall_s'] / max(ptf['rounds'], 1) * 1e3:.3f} ms per "
        f"round (engine build and store packing per query included); "
        f"[sched] {sched['rounds']} rounds, "
        f"{sched['wall_s'] / sched['rounds'] * 1e3:.3f} ms per round, "
        f"scheduler hooks {sched['hooks_s'] / sched['rounds'] * 1e3:.4f} ms "
        f"host per round, kernel 1 {us(sched['check']['device_ms'])} us a "
        f"launch on a contended round; [rollup] {rollup['rounds']} rounds, "
        f"{rollup['wall_s'] / max(rollup['rounds'], 1) * 1e3:.3f} ms per "
        f"round, {rollup['tier1']} tier-1 answers; [spmd-parity] and "
        f"[spmd] {spmd_s:.1f} s")
    log("[done]")

    def timed(name, b):
        v = stimes.get((name, b)) or gtimes[(name, b)]
        return dict(**measured(v["device_ms"], v["call_ms"]),
                    plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                    bound_by=v["bound"][1], library_ms=None)

    t_rows = int(store.chunk_sizes[0])
    kernels = [{
        "name": "slot_extract", "route": "cuda",
        "source": "src/repro_torch/csrc/slot_extract.cu",
        "replaces": "src/repro/kernels/slot_extract.py:101",
        "launches": launches,
        "launches_by_path": {"packed": launches, "sched": sched["launches"],
                             "rollup": rollup["launches"],
                             "ptf": ptf["launches"],
                             "spmd": [o["launches"]["slot_extract"]
                                      for o in spmd["ranks"]],
                             "ingest": ml["ingest"]["launches"],
                             "train": ml["train"]["launches"],
                             "families-train":
                                 ml["families-train"]["launches"],
                             "verify-cell": [
                                 o["replicated"]["launches"]
                                 for o in shard["verify"]["ranks"]],
                             "examples": ml["examples"]["launches"]},
        "max_abs_err": max(r["max_abs_err_cols"] for r in checks
                           if r["max_abs_err_cols"] is not None),
        "max_rel_err_sums": max(r["max_rel_err_sums"] for r in checks),
        **measured(times["ms"], times["call_ms"][4096]),
        "plain_ms": times["plain_ms"],
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
    }, {
        "name": "slot_extract_grouped", "route": "cuda",
        "source": "src/repro_torch/csrc/slot_extract_grouped.cu",
        "replaces": "src/repro/kernels/slot_extract.py:252",
        "launches": gdep["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in gchecks),
        "max_rel_err_sums": max(r["max_rel_err_sums"] for r in gchecks),
        **timed("slot_extract_grouped", 4096),
    }, {
        "name": "chunk_agg", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_agg.cu",
        "replaces": "src/repro/kernels/chunk_agg.py:67",
        "launches": rows_run["chunk_agg_launches"],
        "max_abs_err": rows_run["max_abs_err"],
        "max_rel_err_sums": rows_run["chunk_agg_rel"],
        **timed("chunk_agg", NUM_CHUNKS),
    }, {
        "name": "round_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/round_stats.cu",
        "replaces": "src/repro/kernels/round_stats.py:44",
        "launches": rows_run["round_stats_launches"],
        "max_abs_err": rows_run["rs_max_abs_err"],
        "max_rel_err_sums": rows_run["round_stats_rel"],
        **timed("round_stats", 4096),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
