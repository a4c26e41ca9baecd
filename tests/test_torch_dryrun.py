"""The port's dry run (``repro_torch.launch.dryrun``) on fake process
groups in this process (meta DTensors: no memory, no communication).

* Per-rank FLOPs: the reduced smollm-135m train cell at (8, 64) counts on
  a fake (1, 1) mesh the single-device step's 1,006,632,960 matmul FLOPs
  (its loss and gradient alone count the same);
  on a fake (4, 2) mesh every rank holds blocks of rank 0's shapes (so
  runs rank 0's ops), and the 8 ranks together count the single-device
  step's FLOPs plus what the model axis
  replicates: the reduced config's one KV head does not split over 2
  ranks, so the K and V projections run whole on both model ranks, while
  the query heads, and with them attention's ``bmm``s, split over them
  (the reference's rules: ``q_heads`` over the model axis, ``kv_heads``
  replicated; ``distributed/layout.py``).  The same holds for the decode
  cell at (16, 64): its cache is sharded over T on the model axis, each
  rank scores its own block of T, and no all-gather moves the cache
  (``kv_cache_gather_bytes`` 0).
* A record of that cell on the (4, 2) mesh has the reference's keys
  (read from ``repro/launch/dryrun.py``'s source and its
  ``analyze_lowered``), its argument bytes equal the local bytes of the
  DTensors ``materialize`` makes for the same layouts, and its collective
  counts equal ``CommDebugMode``'s (which reads each shard-dim
  all-to-all on a CPU-typed mesh as DTensor's fallback all-gather).
* The same for the sharded verify cell at a cut chunk count (16 chunks of
  4,096 tuples; its argument bytes from the production layouts: the
  replicated state, the rank's 1,024 of 4,096 chunks, its worker's speed).
* ``scripts/roofline_table.py`` reads a port record unchanged.
* The train step is donated (updated in place, as the reference's
  ``donate_argnums=(0,)``): the plain step's own bytes on one row stay
  below its state's bytes, and a train record's outputs alias all of its
  state (``memory.alias_bytes``).  Rank 0 of the (4, 2) mesh runs no op
  whose result is larger than its own float32 block of the logits (the
  vocab-parallel cross entropy and the LM head per rank).
* The records' memory and cost fields are integers from the walk:
  ``peak_bytes == argument_bytes + temp_bytes``, ``flops`` and
  ``bytes_accessed`` the roofline's terms.  The (1, 1) cell's walk on
  real CPU tensors equals its walk on meta to the byte (held, own and
  peak bytes, the peak's op), and its saved trace holds the arguments'
  bytes, each rounded to 512, and marks the record's peak.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.registry import ShapeSpec

ROOT = os.path.join(os.path.dirname(__file__), "..")
SHAPE = ShapeSpec("train_4k", 64, 8, "train")
DECODE = ShapeSpec("decode_32k", 64, 16, "decode")
SINGLE_DEVICE_FLOPS = 1_006_632_960
CUT = {"n_chunks": 16, "m_per_chunk": 4096}


def _local_bytes(tree):
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, DTensor))


def _cell_walk(mesh, device):
    """The walk's memory of the reduced (1, 1) train cell's step on
    ``device``'s arguments, as ``run_cell`` walks it; and the arguments'
    local bytes, each rounded to the walk's granule."""
    from repro_torch.launch.steps import build_cell, materialize, run_cell
    from repro_torch.roofline.dispatch_walk import (
        CUDA_ALLOC_GRANULE, DispatchWalk)
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves

    g = CUDA_ALLOC_GRANULE
    cell = build_cell("smollm-135m", SHAPE, mesh, reduced=True)
    args, _ = materialize(cell, device)
    with DispatchWalk(hold=args, granule=g) as w:
        run_cell(cell, *args)
    held = sum(-(-t.to_local().untyped_storage().nbytes() // g) * g
               for t in tree_leaves(args) if isinstance(t, DTensor))
    return w.memory(), held


def _single_device_walk():
    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_from_module
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline.dispatch_walk import walk
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (
        init_train_state, make_train_step, value_and_grad)

    cfg = get_config("smollm-135m", reduced=True)
    model = build_model(cfg, device="meta")
    toks = torch.empty((SHAPE.global_batch, SHAPE.seq_len),
                       dtype=torch.int32, device="meta")
    state = init_train_state(tree_from_module(model))
    batch = {"tokens": toks, "labels": toks}
    _, w = walk(make_train_step(model.loss_fn, AdamWConfig()), state, batch)
    _, g = walk(value_and_grad, model.loss_fn, state.params, batch)
    # one row of 8 tokens: the activations are small beside the state, so
    # the optimizer's update sets the step's own mark
    row = torch.empty((1, 8), dtype=torch.int32, device="meta")
    _, small = walk(make_train_step(model.loss_fn, AdamWConfig()), state,
                    {"tokens": row, "labels": row})
    state_bytes = sum(t.numel() * t.element_size()
                      for t in torch.utils._pytree.tree_leaves(state)
                      if isinstance(t, torch.Tensor))
    return cfg, w, g, (small, state_bytes)


def _single_device_decode_flops() -> int:
    """The matmul FLOPs of the reduced smollm-135m's decode step at
    DECODE on one device (meta)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline.dispatch_walk import walk

    model = build_model(get_config("smollm-135m", reduced=True, tp=2),
                        device="meta")
    b = DECODE.global_batch
    cache = model.init_cache(b, DECODE.seq_len)
    tokens = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((b,), dtype=torch.int32, device="meta")
    _, w = walk(model.decode_step, cache, tokens, pos)
    return w["matmul_flops"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every drive in sequence (a process has one default group)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell, materialize

    out = {}
    (out["cfg"], out["single"], out["grad"],
     out["donated"]) = _single_device_walk()
    out["decode_single"] = _single_device_decode_flops()
    with dryrun.fake_group(1):
        mesh = make_debug_mesh(1, 1, "cpu")
        out["trace_dir"] = tmp_path_factory.mktemp("dryrun")
        out["one"] = dryrun.run_cell("smollm-135m", SHAPE, False,
                                     str(out["trace_dir"]), True,
                                     reduced=True, mesh=mesh)
        out["walks"] = {dev: _cell_walk(mesh, dev)
                        for dev in ("meta", "cpu")}
    with dryrun.fake_group(8):
        mesh = make_debug_mesh(4, 2, "cpu")
        out["rank0_dir"] = tmp_path_factory.mktemp("dryrun_rank0")
        with CommDebugMode() as comm:
            out["rank0"] = dryrun.run_cell("smollm-135m", SHAPE, False,
                                           str(out["rank0_dir"]), True,
                                           reduced=True, mesh=mesh)
        out["comm"] = dict(comm.get_comm_counts())
        out["decode_rank0"] = dryrun.run_cell("smollm-135m", DECODE,
                                              reduced=True, mesh=mesh)
        cell = build_cell("smollm-135m", SHAPE, mesh, reduced=True)
        args, _ = materialize(cell, "meta")
        out["dtensor_bytes"] = _local_bytes(args)
        out["dtensor_state_bytes"] = _local_bytes(args[0])
        with CommDebugMode() as comm:
            out["verify"] = dryrun.run_verify_cell(
                "sharded", device="cpu", mesh=mesh, cut=CUT)
        out["verify_comm"] = dict(comm.get_comm_counts())
        out["args_bytes_by_rank"] = [dryrun.arg_bytes(cell.args, c)
                                     for c in dryrun.rank_coords(mesh)]
    return out


def _flops(rec):
    return rec["roofline"]["hlo_flops_per_chip"]


def test_one_rank_counts_the_single_device_step(runs):
    assert runs["single"]["matmul_flops"] == SINGLE_DEVICE_FLOPS
    # AdamW's update has no matmul: the step's are its loss and gradient
    assert runs["grad"]["matmul_flops"] == SINGLE_DEVICE_FLOPS
    assert _flops(runs["one"]) == SINGLE_DEVICE_FLOPS
    assert runs["one"]["collective_counts"] == {}


def test_ranks_sum_to_the_single_device_step_and_what_is_replicated(runs):
    cfg, single = runs["cfg"], runs["single"]
    # every rank holds blocks of one shape, so every rank runs rank 0's ops
    assert len(set(runs["args_bytes_by_rank"])) == 1
    model_ranks = 2
    assert cfg.num_kv_heads % model_ranks != 0
    tokens = SHAPE.global_batch * SHAPE.seq_len
    kv = cfg.num_kv_heads * cfg.head_dim_
    # k and v, forward and the two gradients, every layer: the reference's
    # rules replicate the KV heads over the model axis; the query heads
    # (attention's ``bmm``s) split over it
    kv_proj = cfg.num_layers * 2 * 3 * (2 * tokens * cfg.d_model * kv)
    replicated = (model_ranks - 1) * kv_proj
    assert 8 * _flops(runs["rank0"]) == SINGLE_DEVICE_FLOPS + replicated


def test_decode_ranks_sum_to_the_single_device_step_and_what_is_replicated(
        runs):
    """The decode cell on the (4, 2) mesh: the cache is sharded over T on
    the model axis (one KV head), each rank scores its own block of T
    (the softmax split over the model ranks) and nothing of the cache is
    gathered; the 8 ranks count the single-device step's FLOPs plus the
    K and V projections, which run whole on both model ranks."""
    cfg, rec = runs["cfg"], runs["decode_rank0"]
    model_ranks = 2
    assert cfg.num_kv_heads % model_ranks != 0
    assert rec["kv_cache_gather_bytes"] == 0
    kv = cfg.num_kv_heads * cfg.head_dim_
    kv_proj = cfg.num_layers * 2 * (2 * DECODE.global_batch * cfg.d_model
                                    * kv)
    replicated = (model_ranks - 1) * kv_proj
    assert 8 * _flops(rec) == runs["decode_single"] + replicated


def test_the_donated_step_holds_no_second_state(runs):
    """The plain step on one row of 8 tokens updates its state in place:
    its own bytes above the state it holds (the gradients, a third of the
    state, and one leaf's temporaries) stay below the state's bytes; a
    step that built its new state beside the old one held a whole second
    state."""
    walk, state_bytes = runs["donated"]
    mem = walk["memory"]
    assert mem["held_bytes"] >= state_bytes
    assert state_bytes // 3 < mem["temp_peak_bytes"] < state_bytes


def test_no_rank_op_outputs_more_than_its_logits_block(runs):
    """Rank 0 of the (4, 2) mesh: no op's result is larger than the rank's
    own float32 block of the logits (its 2 of 8 rows, 256 of 512 vocab
    columns): the vocab-parallel loss keeps the logits, and their
    gradient, in blocks."""
    cfg = runs["cfg"]
    block = (SHAPE.global_batch // 4) * SHAPE.seq_len * (cfg.vocab_size
                                                          // 2) * 4
    path = runs["rank0_dir"] / "smollm-135m__train_4k__pod.trace.txt"
    largest = 0
    for line in path.read_text().splitlines()[2:]:
        for shape, dtype in ast.literal_eval(line.split("\t")[3]):
            n = torch.empty((), dtype=getattr(torch, dtype)).element_size()
            for d in shape:
                n *= d
            largest = max(largest, n)
    assert 0 < largest <= block


def _reference_record_keys(fn_name: str):
    """Top-level and ``memory`` keys of the reference's dry-run record
    (``record = {...}`` in ``fn_name`` of ``repro/launch/dryrun.py``)."""
    with open(os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "record")
    top = {k.value for k in rec.keys}
    mem = next(v for k, v in zip(rec.keys, rec.values)
               if k.value == "memory")
    return top, {k.value for k in mem.keys}


def _roofline_keys():
    from repro.roofline.analysis import analyze_lowered

    class Compiled:
        def cost_analysis(self):
            return {}

        def as_text(self):
            return "ENTRY %main {\n}\n"

    return set(analyze_lowered(None, Compiled(), "smollm-135m", "train_4k",
                               1)["roofline"])


@pytest.mark.parametrize("name,ref_fn", [("rank0", "run_cell"),
                                         ("verify", "run_verify_cell")])
def test_record_has_reference_keys(runs, name, ref_fn):
    rec = runs[name]
    top, mem = _reference_record_keys(ref_fn)
    assert top | {"roofline"} <= set(rec)
    assert mem <= set(rec["memory"])
    assert _roofline_keys() <= set(rec["roofline"])
    json.dumps(rec)


def test_argument_bytes_equal_the_layouts_local_bytes(runs):
    rec = runs["rank0"]
    assert rec["memory"]["argument_bytes"] == runs["dtensor_bytes"]
    assert rec["memory"]["state_bytes_by_rank"] == [
        [runs["dtensor_state_bytes"], 8]]
    assert rec["chips"] == 8 and rec["mesh"] == {"data": 4, "model": 2}


def test_verify_cell_argument_bytes(runs):
    from repro_torch.launch.verify_cell import (
        local_state, production_verify_program)

    program = production_verify_program(workers=4, device="cpu")[0]
    state = sum(t.numel() * t.element_size()
                for t in torch.utils._pytree.tree_leaves(
                    local_state(program, 0)) if isinstance(t, torch.Tensor))
    packed = (4096 // 4) * 65536 * 96
    speeds = 1 * 4
    rec = runs["verify"]
    assert rec["memory"]["argument_bytes"] == state + packed + speeds
    assert rec["memory"]["state_bytes_by_rank"] == [[state, 8]]
    assert rec["reduced"] == CUT
    assert rec["roofline"]["model_flops"] is None


def _kinds(counts: dict) -> dict:
    names = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce", "allreduce_": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "shard_dim_alltoall": "all-to-all"}
    out = {}
    for op, n in counts.items():
        kind = names[str(op).rsplit(".", 1)[-1]]
        out[kind] = out.get(kind, 0) + n
    return out


def test_collective_counts_equal_comm_debug_mode(runs):
    got = dict(runs["rank0"]["collective_counts"])
    want = _kinds(runs["comm"])
    # a CPU-typed mesh runs each shard-dim all-to-all as an all-gather
    got["all-gather"] = got.get("all-gather", 0) + got.pop("all-to-all", 0)
    assert got == want
    assert runs["rank0"]["roofline"]["collective_detail"]["count"] == sum(
        runs["rank0"]["collective_counts"].values())
    assert runs["verify"]["collective_counts"] == _kinds(
        runs["verify_comm"]) == {"all-reduce": 3}


def test_roofline_table_reads_a_port_record(runs, tmp_path):
    out = tmp_path / "results" / "dryrun"
    out.mkdir(parents=True)
    (out / "smollm-135m__train_4k__pod.json").write_text(
        json.dumps(runs["rank0"]))
    res = subprocess.run(
        [sys.executable, os.path.abspath(os.path.join(
            ROOT, "scripts", "roofline_table.py"))],
        cwd=tmp_path, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    rows = [r for r in res.stdout.splitlines()
            if r.startswith("| smollm-135m | train_4k |")]
    assert len(rows) == 1
    assert f"| {runs['rank0']['roofline']['dominant'][:-2]} |" in rows[0]


@pytest.mark.parametrize("name", ["one", "rank0", "verify"])
def test_memory_and_cost_fields_from_the_walk(runs, name):
    rec = runs[name]
    mem, rf = rec["memory"], rec["roofline"]
    for v in (mem["temp_bytes"], mem["peak_bytes"], rec["flops"],
              rec["bytes_accessed"]):
        assert isinstance(v, int)
    assert min(mem["temp_bytes"], rec["bytes_accessed"]) > 0
    # the OLA round runs no matmul
    assert (rec["flops"] > 0) == (name != "verify")
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    # a step's own bytes hold at least its outputs that alias no argument
    # (the train step's state is donated: its outputs are its arguments)
    assert 0 <= mem["alias_bytes"] <= mem["output_bytes"]
    assert mem["temp_bytes"] >= mem["output_bytes"] - mem["alias_bytes"]
    if name != "verify":
        # the train step's outputs alias every byte of the state it took
        assert mem["alias_bytes"] == mem["state_bytes_by_rank"][0][0]
    assert rec["flops"] == rf["hlo_flops_per_chip"]
    assert rec["bytes_accessed"] == rf["hlo_bytes_per_chip"]
    # the walk's granule is the CUDA caching allocator's
    assert mem["temp_bytes"] % 512 == 0


def test_meta_walk_equals_the_real_tensor_walk(runs):
    (meta, held), (real, _) = runs["walks"]["meta"], runs["walks"]["cpu"]
    # ``torch.tensor`` dispatches a ``lift_fresh`` on the CPU, none on
    # meta: the op counts may differ by those, the bytes may not
    assert 0 <= real["ops"] - meta["ops"] <= 1
    assert ({k: v for k, v in real.items() if k != "ops"}
            == {k: v for k, v in meta.items() if k != "ops"})
    assert real["peak_bytes"] == meta["peak_bytes"] == held + meta[
        "temp_peak_bytes"]
    assert meta["temp_peak_bytes"] == runs["one"]["memory"]["temp_bytes"]


def test_saved_trace_holds_the_arguments_and_marks_the_peak(runs):
    rec = runs["one"]
    path = runs["trace_dir"] / "smollm-135m__train_4k__pod.trace.txt"
    assert (runs["trace_dir"] / "smollm-135m__train_4k__pod.json").exists()
    lines = path.read_text().splitlines()
    mem = rec["memory"]
    held = runs["walks"]["meta"][1]
    assert lines[0] == (
        f"# granule 512 B; held {held} B; the step's own peak "
        f"{mem['temp_bytes']} B at op "
        f"{lines[0].split(' at op ')[1].split(';')[0]}; peak with what it "
        f"holds {held + mem['temp_bytes']} B")
    marked = [ln.split("\t") for ln in lines[2:] if ln.endswith("<- peak")]
    assert len(marked) == 1
    assert int(marked[0][6]) == mem["temp_bytes"]
    assert sum(int(ln.split("\t")[4]) for ln in lines[2:]) == rec["flops"]
