"""The port's roofline accounting (``repro_torch.roofline``) held to the
reference's (``repro.roofline``) piece by piece, in one process.

The reference's dry run cannot lower its own cells on jax 0.9.0 (ROADMAP,
"A condition of the reference"), so whole records are not compared:

* ``model_flops`` equals the reference's exactly for all 40 ``(arch,
  shape)`` pairs of ``cells(include_skipped=True)``.
* The matmul FLOPs that ``DispatchWalk`` counts in a reduced single-device
  step (the meta device: nothing allocated) equal
  ``repro.roofline.hlo_walk.walk(...)["matmul_flops"]`` of the
  reference's same step, jitted without a mesh and compiled on the CPU,
  exactly: smollm-135m and mixtral-8x7b train at (2, 64), smollm's train
  step with ``remat=True``, its prefill and its decode step, and the
  hybrid and xLSTM families' train steps.  A train step's matmuls are
  its loss and gradient (AdamW's update has none; ``test_torch_dryrun``
  checks the port's whole step against its gradient), so both packages'
  are walked alone, which halves the reference's compile.  Two rewrites are pinned op by
  op (ROADMAP, "Divergences"):
  - zamba2-1.2b: each of a Mamba layer's three SSD einsums has a second
    operand of decay factors without the head dim P; its gradient is a
    product summed over P, which XLA emits as a dot (batch dims all but
    P) and torch's einsum backward as a multiply and a sum, no matmul;
  - xlstm-125m: the sLSTM's four recurrent products ``bhk,hkl->bhl``
    need no gradient for their step-0 input (the zero initial state);
    torch's autograd skips it, while XLA's rolled time scan runs the same
    body, that dot included, at every step.
* The argument and output bytes of the reduced smollm-135m train step's
  loss and gradient, walked on meta, equal the reference's
  ``memory_analysis()`` of the compile the FLOP test already made: the
  arguments exactly, the outputs less XLA's result tuple's index table
  (8 bytes a result); the port's peak holds at least both.
* ``collective_bytes`` equals the reference's on the HLO of
  ``tests/test_sharding_roofline.py``'s parsing test plus one
  reduce-scatter and one all-to-all line.
* ``analyze_step`` returns the reference's ``"roofline"`` keys.
* The H100's constants and their use by the link pricing.
"""

import ast
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import cells
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.dispatch_walk import Collective, walk

ROOT = os.path.join(os.path.dirname(__file__), "..")
SDS = jax.ShapeDtypeStruct


# LLVM's work only: XLA's HLO passes, which place and rewrite the dots,
# run as in a default compile
FAST_CODEGEN = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _ref_step_text(arch, kind, b, s, overrides):
    """The reference's compiled HLO: for a train step, the loss and its
    gradient (the step's matmuls: AdamW's update has none)."""
    compiled, cfg = _ref_compiled(arch, kind, b, s,
                                  tuple(sorted(overrides.items())))
    return compiled.as_text(), cfg


@functools.lru_cache(maxsize=None)
def _ref_compiled(arch, kind, b, s, overrides):
    """The reference's compiled step (each compiled once a process) and
    its config."""
    from repro.configs.registry import get_config
    from repro.models import build_model

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              **dict(overrides))
    model = build_model(cfg)
    params = jax.eval_shape(lambda k: model.init(k)[0],
                            jax.random.PRNGKey(0))
    toks = SDS((b, s), jnp.int32)
    if kind == "train":
        lowered = jax.jit(jax.value_and_grad(
            lambda p, bt: model.loss(p, bt))).lower(
            params, {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        lowered = jax.jit(lambda p, t: model.prefill(p, t)).lower(params,
                                                                  toks)
    else:
        cache = jax.eval_shape(lambda: model.init_cache(b, s))
        lowered = jax.jit(
            lambda p, c, t, q: model.decode_step(p, c, t, q)).lower(
            params, cache, SDS((b, 1), jnp.int32), SDS((b,), jnp.int32))
    return lowered.compile(compiler_options=FAST_CODEGEN), cfg


def _port_step_walk(arch, kind, b, s, overrides):
    """The port's step on the meta device (a train step's loss and
    gradient, as the reference's)."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_from_module
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import value_and_grad

    cfg = dataclasses.replace(get_config(arch, reduced=True), **overrides)
    model = build_model(cfg, device="meta")
    toks = torch.empty((b, s), dtype=torch.int32, device="meta")
    params = tree_from_module(model)
    if kind == "train":
        _, w = walk(value_and_grad, model.loss_fn, params,
                    {"tokens": toks, "labels": toks})
    elif kind == "prefill":
        _, w = walk(lambda: model.apply(params, toks)[0][:, -1:])
    else:
        cache = model.init_cache(b, s)
        _, w = walk(model.decode_step, cache,
                    torch.empty((b, 1), dtype=torch.int32, device="meta"),
                    torch.zeros((b,), dtype=torch.int32, device="meta"))
    return w


def _ssd_decay_grads(cfg, b, s):
    """zamba2: per Mamba layer, 3 dots of 2·|out|·K the reference's
    backward has and the port's computes without a matmul (module doc):
    out (B, NC, Q, H) contracting P for two, (B, NC, Q, Q) contracting H
    for the third."""
    d_inner = 2 * cfg.d_model
    h, p, q = d_inner // cfg.ssm_headdim, cfg.ssm_headdim, cfg.ssm_chunk
    nc = s // q
    return cfg.num_layers * (2 * (2 * b * nc * q * h * p)
                             + 2 * b * nc * q * q * h)


def _slstm_first_input_grads(cfg, b, s):
    """xlstm: per sLSTM layer, the four gates' ``bhk,hkl->bhl`` gradient
    with respect to the step-0 input: 2·(B·H·dh)·dh each."""
    dh = cfg.d_model // cfg.num_heads
    return len(cfg.slstm_at) * 4 * 2 * b * cfg.num_heads * dh * dh


# (arch, kind, overrides, the reference's extra FLOPs or None)
STEPS = [
    ("smollm-135m", "train", {}, None),
    ("mixtral-8x7b", "train", {}, None),
    ("smollm-135m", "train", {"remat": True}, None),
    ("smollm-135m", "prefill", {}, None),
    ("smollm-135m", "decode", {}, None),
    ("zamba2-1.2b", "train", {}, _ssd_decay_grads),
    ("xlstm-125m", "train", {}, _slstm_first_input_grads),
]
# the two steps whose counts are pinned, at (2, 64)
PINNED = {("smollm-135m", "train", ()): 251_658_240,
          ("mixtral-8x7b", "train", ()): 629_932_032}


@pytest.mark.parametrize("arch,kind,overrides,extra", STEPS,
                         ids=[f"{a}-{k}{'-remat' if o else ''}"
                              for a, k, o, _ in STEPS])
def test_matmul_flops_equal_reference_walker(arch, kind, overrides, extra):
    from repro.roofline.hlo_walk import walk as hlo_walk

    b, s = 2, 64
    text, cfg = _ref_step_text(arch, kind, b, s, overrides)
    ref = hlo_walk(text)
    assert ref["unresolved_trip_counts"] == 0
    got = _port_step_walk(arch, kind, b, s, overrides)
    diff = 0 if extra is None else extra(cfg, b, s)
    assert got["matmul_flops"] + diff == ref["matmul_flops"]
    assert got["matmul_flops"] > 0
    want = PINNED.get((arch, kind, tuple(overrides)))
    if want is not None:
        assert got["matmul_flops"] == want


def _leaf_bytes(tree, path=""):
    """``{path: bytes}`` of a tree of dicts of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_bytes(v, f"{path}/{k}"))
        return out
    return {path: int(np.prod(tree.shape)) * np.dtype(
        str(tree.dtype).removeprefix("torch.")).itemsize}


def test_memory_equals_reference_arguments_and_outputs():
    """The reduced smollm-135m train step's loss and gradient at (2, 64)
    (the FLOP test's first compile): arguments = the parameters, tokens
    and labels; outputs = the loss and one gradient a parameter.  XLA's
    ``output_size_in_bytes`` also counts its result tuple's index table,
    8 bytes a result.  Its ``peak_memory_in_bytes`` is not held: XLA
    fuses ops and reuses buffers by its own schedule."""
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_from_module
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline.dispatch_walk import DispatchWalk
    from repro_torch.train.train_step import value_and_grad

    b, s = 2, 64
    compiled, ref_cfg = _ref_compiled("smollm-135m", "train", b, s, ())
    mem = compiled.memory_analysis()
    ref_params = jax.eval_shape(
        lambda k: ref_build_model(ref_cfg).init(k)[0],
        jax.random.PRNGKey(0))

    model = build_model(get_config("smollm-135m", reduced=True),
                        device="meta")
    params = tree_from_module(model)
    assert _leaf_bytes(params) == _leaf_bytes(ref_params)
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with DispatchWalk(hold=(params, batch)) as w:
        loss, grads = value_and_grad(model.loss_fn, params, batch)
    assert w.held_bytes == mem.argument_size_in_bytes
    results = [loss] + torch.utils._pytree.tree_leaves(grads)
    out_bytes = sum(t.numel() * t.element_size() for t in results)
    assert out_bytes + 8 * len(results) == mem.output_size_in_bytes
    assert w.peak_bytes >= w.held_bytes + out_bytes


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in
                                        cells(include_skipped=True)])
def test_model_flops_equal_reference(arch, shape):
    from repro.roofline.analysis import model_flops as ref_model_flops

    assert len(cells(include_skipped=True)) == 40
    for n in (256, 512):
        assert analysis.model_flops(arch, shape, n) == ref_model_flops(
            arch, shape, n)


# the reference's parsing test's three lines, a reduce-scatter and an
# all-to-all, and the same five collectives as the walk records them
HLO = """
  %ar = f32[1024,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%sum
  %ag = bf16[8,256]{1,0} all-gather(%y), replica_groups=[2,8]<=[16], dimensions={0}
  %cp = f32[64]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %rs = f32[256,64]{1,0} reduce-scatter(%w), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}, to_apply=%sum
  %aa = bf16[32,128]{1,0} all-to-all(%v), replica_groups={{0,1}}, dimensions={0}
"""
RECORDS = [
    Collective("all-reduce", 1024 * 512 * 4, 4, (0, 1, 2, 3)),
    Collective("all-gather", 8 * 256 * 2, 8, tuple(range(8))),
    Collective("collective-permute", 64 * 4, 2, (0, 1)),
    Collective("reduce-scatter", 256 * 64 * 4, 8, tuple(range(8))),
    Collective("all-to-all", 32 * 128 * 2, 2, (0, 1)),
]


def test_collective_bytes_equal_reference():
    from repro.roofline.analysis import collective_bytes as ref_bytes

    want = ref_bytes(HLO)
    got = analysis.collective_bytes(RECORDS)
    assert set(got) == set(want)
    assert got["count"] == want["count"] == 5
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_links_priced_by_the_nodes_a_group_spans():
    """NVLink inside a node of 8 consecutive ranks, the inter-node link
    across nodes: on the 16 x 16 production mesh (model innermost) a
    model group of 16 spans two nodes."""
    h = hw.H100_SXM
    model_group = tuple(range(16))
    data_group = tuple(range(0, 256, 16))
    assert analysis.link_bw(range(8), h) == h.nvlink_bw
    assert analysis.link_bw(range(8, 16), h) == h.nvlink_bw
    assert analysis.link_bw(model_group, h) == h.inter_node_bw
    assert analysis.link_bw(data_group, h) == h.inter_node_bw
    recs = [Collective("all-reduce", 1 << 20, 8, tuple(range(8))),
            Collective("all-gather", 1 << 20, 16, model_group)]
    secs, by_link = analysis.collective_seconds(recs, h)
    ar = 2.0 * (1 << 20) * 7 / 8
    ag = (1 << 20) * 15 / 16
    assert by_link == {"nvlink": ar, "inter_node": ag}
    assert secs == pytest.approx(ar / h.nvlink_bw + ag / h.inter_node_bw)


def test_h100_constants_and_their_readers():
    h = hw.H100_SXM
    assert (h.peak_flops_bf16, h.peak_flops_f32, h.hbm_bw, h.hbm_bytes) == (
        989.4e12, 67e12, 3.35e12, 80e9)
    assert h.nvlink_bw == 450e9 and h.inter_node_bw == 50e9
    assert h.node_size == 8
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    assigned = {t.id: ast.unparse(node.value) for node in tree.body
                if isinstance(node, ast.Assign) for t in node.targets
                if isinstance(t, ast.Name)}
    assert assigned["HBM_BYTES_PER_S"] == "H100_SXM.hbm_bw"
    assert assigned["F32_OPS_PER_S"] == "H100_SXM.peak_flops_f32"


def test_analyze_step_has_reference_keys():
    from repro.roofline.analysis import analyze_lowered

    class Compiled:
        def cost_analysis(self):
            return {}

        def as_text(self):
            return "ENTRY %main {\n}\n"

    want = analyze_lowered(None, Compiled(), "smollm-135m", "train_4k",
                           256)["roofline"]
    w = {"matmul_flops": 2.0e12, "dot_count": 3,
         "flops_by_dtype": {"torch.bfloat16": 1.0e12,
                            "torch.float32": 1.0e12},
         "hbm_bytes": 3.35e9, "collective": {}, "collective_count": 2,
         "collectives": RECORDS[:2]}
    got = analysis.analyze_step(w, "smollm-135m", "train_4k", 256)[
        "roofline"]
    assert set(want) <= set(got)
    assert got["hlo_flops_raw_per_chip"] is None
    assert got["dot_unresolved"] is None
    h = hw.H100_SXM
    assert got["compute_s"] == pytest.approx(1e12 / h.peak_flops_bf16
                                             + 1e12 / h.peak_flops_f32)
    assert got["memory_s"] == pytest.approx(1e-3)
    assert got["dominant"] == "compute_s"
    assert got["bound_s"] == got["compute_s"]
    assert got["model_flops"] == want["model_flops"]
