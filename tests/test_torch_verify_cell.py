"""The OLA-verify cell (``repro_torch.launch.verify_cell``) on gloo ranks.

The program is ``tests/test_verify_cell.py``'s: 16 chunks × 64 tuples ×
6 ASCII columns, 8 workers, ``budget=16``, the three production queries at
ε = 1e-9 (so every query runs to exhaustion).  For each rank count D ∈
{2, 4, 8}:

* the port's sharded round on D gloo ranks (``torch.multiprocessing``,
  start method ``spawn``, one rank group a D) equals the reference's
  ``_sharded_round`` under ``shard_map`` on D host devices (one subprocess
  a D with ``--xla_force_host_platform_device_count=D``) every round:
  integers equal, floats within float32 1e-5 relative (of the largest
  magnitude of the field);
* every rank holds the same state after every round;
* at exhaustion every estimate is within 5e-3 of the truth;
* the replicated layout on D ranks equals the single-device round
  (``EngineProgram.round_body`` with all 8 workers) bit for bit.
"""

import datetime
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

RANKS = (2, 4, 8)
MAX_ROUNDS = 100
JOIN_S = 240.0
RTOL = 1e-5
N_CHUNKS, M, COLS, WORKERS, BUDGET = 16, 64, 6, 8, 16

STATE_INTS = ("m", "offset", "closed", "raw_touched", "scan_m", "head",
              "round", "stopped", "decided", "tuples_round", "n_chunks",
              "m_tuples", "exhausted", "cpu_bound")
STATE_FLOATS = ("ysum", "ysq", "psum", "t_io", "t_cpu", "estimate", "lo",
                "hi", "err", "bytes_round")


def _values() -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(0, 100, (M, COLS))
                     for _ in range(N_CHUNKS)])


def _record(state, rep) -> dict:
    def np_(x):
        return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))

    out = {f: np_(getattr(state.stats, f)) for f in ("m", "ysum", "ysq",
                                                     "psum")}
    for f in ("offset", "closed", "raw_touched", "scan_m", "head", "round",
              "stopped", "t_io", "t_cpu", "cpu_bound"):
        out[f] = np_(getattr(state, f))
    for f in ("estimate", "lo", "hi", "err", "decided", "tuples_round",
              "n_chunks", "m_tuples", "exhausted", "bytes_round"):
        out[f] = np_(getattr(rep, f))
    return out


# ---------------------------------------------------------------------------
# The JAX reference, one subprocess per rank count
# ---------------------------------------------------------------------------

_REF_SCRIPT = r"""
import os, sys
D = int(sys.argv[1])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={D}"
import pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.launch.verify_cell as vc
from repro.core.engine import EngineConfig, EngineProgram
from repro.core.engine_spmd import engine_state_specs
from repro.core.queries import Column, Having, Query, Range, TRUE
from repro.data.formats import AsciiFixedFormat

def small_program(budget):
    codec = AsciiFixedFormat(6)
    queries = [
        Query(agg="avg", expr=Column(1), pred=TRUE, having=Having(">", 75.0),
              epsilon=1e-9, name="avg_quality"),
        Query(agg="avg", expr=Column(3), pred=TRUE, having=Having("<", 10.0),
              epsilon=1e-9, name="avg_dup"),
        Query(agg="count", pred=Range(0, 0.0, 16.0), having=Having("<", 1e6),
              epsilon=1e-9, name="short_docs"),
    ]
    cfg = EngineConfig(num_workers=8, strategy="resource_aware",
                       budget_init=budget, seed=0)
    sizes = np.full(16, 64, np.int64)
    return EngineProgram(codec=codec, queries=queries, config=cfg,
                         n_chunks=16, m_max=64, chunk_sizes=sizes), cfg, codec

vc.production_verify_program = lambda **kw: small_program(kw.get("budget", 16))
mesh = jax.make_mesh((D,), ("data",))
fn, args, program = vc.build_verify_cell(mesh, layout="sharded", budget=16)
step = jax.jit(fn)
vals = np.load(sys.argv[2])
raw = np.stack([program.codec.encode(v) for v in vals])
packed = jax.device_put(jnp.asarray(raw), NamedSharding(mesh, P("data")))
speeds = jax.device_put(jnp.ones(8, jnp.float32),
                        NamedSharding(mesh, P("data")))
state = jax.device_put(program.init_state(), jax.tree.map(
    lambda s: NamedSharding(mesh, s), engine_state_specs(),
    is_leaf=lambda x: isinstance(x, P)))
trace = []
for _ in range(int(sys.argv[4])):
    state, rep = step(state, packed, speeds)
    rec = {f: np.asarray(getattr(state.stats, f)) for f in ("m", "ysum", "ysq", "psum")}
    for f in ("offset", "closed", "raw_touched", "scan_m", "head", "round",
              "stopped", "t_io", "t_cpu", "cpu_bound"):
        rec[f] = np.asarray(getattr(state, f))
    for f in ("estimate", "lo", "hi", "err", "decided", "tuples_round",
              "n_chunks", "m_tuples", "exhausted", "bytes_round"):
        rec[f] = np.asarray(getattr(rep, f))
    trace.append(rec)
    if bool(rep.exhausted):
        break
with open(sys.argv[3], "wb") as f:
    pickle.dump(trace, f)
"""


# ---------------------------------------------------------------------------
# The port, on gloo ranks
# ---------------------------------------------------------------------------

def _program():
    from repro_torch.core.engine import EngineConfig, EngineProgram
    from repro_torch.core.queries import Column, Having, Query, Range, TRUE
    from repro_torch.data.formats import AsciiFixedFormat

    codec = AsciiFixedFormat(COLS)
    queries = [
        Query(agg="avg", expr=Column(1), pred=TRUE, having=Having(">", 75.0),
              epsilon=1e-9, name="avg_quality"),
        Query(agg="avg", expr=Column(3), pred=TRUE, having=Having("<", 10.0),
              epsilon=1e-9, name="avg_dup"),
        Query(agg="count", pred=Range(0, 0.0, 16.0), having=Having("<", 1e6),
              epsilon=1e-9, name="short_docs"),
    ]
    cfg = EngineConfig(num_workers=WORKERS, strategy="resource_aware",
                       budget_init=BUDGET, seed=0)
    return EngineProgram(codec=codec, queries=queries, config=cfg,
                         n_chunks=N_CHUNKS, m_max=M,
                         chunk_sizes=np.full(N_CHUNKS, M, np.int64),
                         device="cpu")


def _packed(program, values) -> torch.Tensor:
    return torch.as_tensor(np.stack([program.codec.encode(v)
                                     for v in values]))


def _rank_main(rank, ranks, init_file, out_dir, values):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.verify_cell import build_verify_cell, local_state

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh("cpu", (ranks,), mesh_dim_names=("data",))
    out = {}
    wpd = WORKERS // ranks
    for layout in ("sharded", "replicated"):
        program = _program()
        step, _, _ = build_verify_cell(mesh, layout, BUDGET, program=program,
                                       device="cpu")
        packed = _packed(program, values)
        if layout == "sharded":
            nl = N_CHUNKS // ranks
            packed = packed[rank * nl:(rank + 1) * nl].clone()
        speeds = torch.ones(wpd, dtype=torch.float32)
        state = local_state(program, rank, wpd)
        trace = []
        for _ in range(MAX_ROUNDS):
            state, rep = step(state, packed, speeds)
            trace.append(_record(state, rep))
            if bool(rep.exhausted):
                break
        out[layout] = trace
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _spawn(ranks: int, values) -> list:
    with tempfile.TemporaryDirectory(prefix="verify_cell_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(ranks, os.path.join(tmp, "pg"), tmp, values),
            nprocs=ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_S
        try:
            while not ctx.join(timeout=2):
                if time.monotonic() > deadline:
                    raise AssertionError(f"{ranks} ranks did not finish in "
                                         f"{JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _reference(ranks: int, values, tmp) -> subprocess.Popen:
    vpath = os.path.join(tmp, "values.npy")
    np.save(vpath, values)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = os.path.join(tmp, f"ref{ranks}.pkl")
    return subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(ranks), vpath, out,
         str(MAX_ROUNDS)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank count's port and reference traces (the reference
    subprocesses run while the rank groups do)."""
    values = _values()
    tmp = str(tmp_path_factory.mktemp("verify_cell"))
    procs = {d: _reference(d, values, tmp) for d in RANKS}
    port = {d: _spawn(d, values) for d in RANKS}
    ref = {}
    for d, (proc, path) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(path, "rb") as f:
            ref[d] = pickle.load(f)
    single = _single_device(values)
    return dict(values=values, port=port, ref=ref, single=single)


def _single_device(values) -> list:
    program = _program()
    packed = _packed(program, values)
    speeds = torch.ones(WORKERS, dtype=torch.float32)
    state = program.init_state()
    trace = []
    for _ in range(MAX_ROUNDS):
        state, rep = program.round_body(state, packed, speeds, BUDGET)
        trace.append(_record(state, rep))
        if bool(rep.exhausted):
            break
    return trace


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite), what
    err = np.max(np.abs(got[finite].astype(np.float64)
                        - want[finite]), initial=0.0)
    assert err <= RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_round_matches_reference(runs, ranks):
    port, ref = runs["port"][ranks][0]["sharded"], runs["ref"][ranks]
    assert len(port) == len(ref), (len(port), len(ref))
    for r, (g, w) in enumerate(zip(port, ref)):
        for f in STATE_INTS:
            assert np.array_equal(np.asarray(g[f]).astype(np.int64),
                                  np.asarray(w[f]).astype(np.int64)), (r, f)
        for f in STATE_FLOATS:
            _close(g[f], w[f], (r, f))


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_ranks_agree_and_exact_at_exhaustion(runs, ranks):
    traces = [o["sharded"] for o in runs["port"][ranks]]
    for other in traces[1:]:
        assert len(other) == len(traces[0])
        for g, w in zip(other, traces[0]):
            for f in w:
                assert np.asarray(g[f]).tobytes() == np.asarray(
                    w[f]).tobytes(), f
    last = traces[0][-1]
    assert bool(last["exhausted"])
    flat = runs["values"].reshape(-1, COLS)
    truth = [flat[:, 1].mean(), flat[:, 3].mean(),
             float(((flat[:, 0] >= 0) & (flat[:, 0] < 16)).sum())]
    est = np.asarray(last["estimate"], np.float64)
    for e, t in zip(est, truth):
        assert abs(e - t) / max(abs(t), 1.0) < 5e-3, (est, truth)


@pytest.mark.parametrize("ranks", RANKS)
def test_replicated_layout_equals_single_device(runs, ranks):
    want = runs["single"]
    for o in runs["port"][ranks]:
        got = o["replicated"]
        assert len(got) == len(want)
        for r, (g, w) in enumerate(zip(got, want)):
            for f in w:
                a, b = np.asarray(g[f]), np.asarray(w[f])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                    (r, f)
