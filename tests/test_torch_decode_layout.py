"""Cached decode on a mesh held to the reference's compiled plan.

The reference's ``decode_attention`` is jitted with its layouts on a
(data 2, model 4) mesh of 8 host devices (one subprocess, ``XLA_FLAGS``
set before jax is imported) and compiled; ``repro.roofline.hlo_walk``
reads the HLO.  The layouts are the reference's rules and
``_kv_cache_shardings``: ``wq`` over (data, model), ``wk``/``wv`` over
data, ``wo`` over (model, -, data), ``x`` and ``pos`` over data, the
cache (B 8, T 4096, Hk, D 64) over data and, on model, over the KV heads
where 4 divides them (Hk = 4) or else over T (Hk = 2), its positions over
(data, model).  The port's ``decode_attention`` runs on meta DTensors of
the same shapes and layouts on a fake (2, 4) group under
``DispatchWalk``, as rank 0:

* Rank 0's matmul FLOPs equal the reference's but for one difference,
  pinned op by op: the port's K and V projections run whole on every
  model rank (the rules replicate ``kv_heads`` over the model axis),
  while XLA splits them over the 4 model ranks, by their contraction
  where the cache is over T (a (4, 32) × (32, 128) product and an
  all-reduce of the partials) and by the KV heads where it is over them
  ((4, 128) × (128, 64)).  Every other product is the same on both
  sides: the query projection, the scores and P·V over the rank's own
  block of the cache, the output projection.
* No all-gather in the port moves the cache: none has a floating result
  of the cache's shape (4 dims, D last, more than one slot), and the only
  all-gathers of a T extent are the booleans of the mask in the
  head-sharded case, as many bytes as the reference's one ``pred``
  all-gather there; where the cache is over T, neither side gathers
  anything of T, and the port's softmax crosses ranks in 3 all-reduces
  over the model axis (the row max, the sum, P·V).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

B, T, D, D_MODEL, H = 8, 4096, 64, 128, 8
MESH = (2, 4)
KV_HEADS = (2, 4)         # over T; over the heads

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, re, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.attention import AttnConfig, decode_attention
from repro.roofline.hlo_walk import walk

B, T, D, d, H = json.loads(sys.argv[1])
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for hk in json.loads(sys.argv[2]):
    cfg = AttnConfig(d_model=d, num_heads=H, num_kv_heads=hk, head_dim=D,
                     heads_padded=H, kv_heads_padded=hk)
    kv = P("data", None, "model") if hk % 4 == 0 else P("data", "model")
    f32, i32 = jnp.float32, jnp.int32
    leaves = (
        {"wq": ((d, H, D), f32, P("data", "model")),
         "wk": ((d, hk, D), f32, P("data")),
         "wv": ((d, hk, D), f32, P("data")),
         "wo": ((H, D, d), f32, P("model", None, "data"))},
        ((B, 1, d), f32, P("data")),
        {"k": ((B, T, hk, D), f32, kv), "v": ((B, T, hk, D), f32, kv),
         "pos": ((B, T), i32, P("data", "model"))},
        ((B,), i32, P("data")))
    is_leaf = lambda x: isinstance(x, tuple) and isinstance(x[0], tuple)
    args = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a[0], a[1]), leaves,
                        is_leaf=is_leaf)
    shard = jax.tree.map(lambda a: NamedSharding(mesh, a[2]), leaves,
                         is_leaf=is_leaf)
    fn = jax.jit(lambda p, x, c, pos: decode_attention(p, cfg, x, c, pos),
                 in_shardings=shard)
    text = fn.lower(*args).compile().as_text()
    gathers = []
    for m in re.finditer(r"= (\w+)\[([0-9,]*)\]\{[^}]*\} all-gather\(", text):
        shape = [int(n) for n in m.group(2).split(",") if n]
        gathers.append([m.group(1), shape])
    out[hk] = {"matmul_flops": walk(text)["matmul_flops"],
               "all_gathers": gathers}
print(json.dumps(out))
"""

_BYTES = {"pred": 1, "s32": 4, "f32": 4, "bf16": 2}


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, json.dumps([B, T, D, D_MODEL, H]),
         json.dumps(KV_HEADS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return {int(k): v for k, v in
            json.loads(out.stdout.strip().splitlines()[-1]).items()}


def _port_walk(hk: int):
    """Rank 0's walk of the port's ``decode_attention`` on meta DTensors
    laid out as the reference's arguments, on a fake (2, 4) group."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import distribute, named
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.attention import AttnConfig, decode_attention
    from repro_torch.roofline.dispatch_walk import DispatchWalk

    mesh = make_debug_mesh(*MESH, "cpu")

    def arg(shape, spec, dtype=torch.float32):
        return distribute(torch.empty(shape, dtype=dtype, device="meta"),
                          named(mesh, spec))

    cfg = AttnConfig(d_model=D_MODEL, num_heads=H, num_kv_heads=hk,
                     head_dim=D, heads_padded=H, kv_heads_padded=hk)
    kv = ("data", None, "model") if hk % MESH[1] == 0 else ("data", "model")
    p = {"wq": arg((D_MODEL, H, D), ("data", "model")),
         "wk": arg((D_MODEL, hk, D), ("data",)),
         "wv": arg((D_MODEL, hk, D), ("data",)),
         "wo": arg((H, D, D_MODEL), ("model", None, "data"))}
    cache = {"k": arg((B, T, hk, D), kv), "v": arg((B, T, hk, D), kv),
             "pos": arg((B, T), ("data", "model"), torch.int32)}
    x = arg((B, 1, D_MODEL), ("data",))
    pos = arg((B,), ("data",), torch.int32)
    with implicit_replication(), DispatchWalk(hold=(p, cache, x, pos)) as w:
        out, _ = decode_attention(p, cfg, x, cache, pos)
    assert tuple(out.shape) == (B, 1, D_MODEL)
    return w


@pytest.fixture(scope="module")
def port():
    from repro_torch.launch import dryrun

    with dryrun.fake_group(MESH[0] * MESH[1]):
        return {hk: _port_walk(hk) for hk in KV_HEADS}


def _kv_projections_split_by_xla(hk: int) -> int:
    """The FLOPs the port's whole K and V projections spend on a model
    rank beyond XLA's split of them over the model axis: each is
    2·B_loc·d·Hk·D on the port's rank, a quarter of that on XLA's."""
    b_loc, m = B // MESH[0], MESH[1]
    whole = 2 * b_loc * D_MODEL * hk * D
    return 2 * (whole - whole // m)


@pytest.mark.parametrize("hk", KV_HEADS, ids=["cache-over-t",
                                               "cache-over-heads"])
def test_rank_matmul_flops_equal_reference(reference, port, hk):
    got = port[hk]
    want = reference[hk]["matmul_flops"]
    assert got.matmul_flops == want + _kv_projections_split_by_xla(hk)
    # op by op: the projections (q, k, v, o) are ``mm``s, the scores and
    # P·V ``bmm``s over the rank's block of the cache; that block is
    # B_loc × T/4 × Hk × D either way (all KV heads over a quarter of T,
    # or a quarter of the KV heads over all of T), each of its slots
    # scored by G = H / Hk query heads
    b_loc, m = B // MESH[0], MESH[1]
    block = b_loc * (T // m) * hk * D * (H // hk)
    assert got.flops_by_op["aten.bmm"] == 2 * 2 * block
    proj = 2 * b_loc * D_MODEL * D
    assert got.flops_by_op["aten.mm"] == (proj * (H // m) * 2
                                          + 2 * proj * hk)


@pytest.mark.parametrize("hk", KV_HEADS, ids=["cache-over-t",
                                               "cache-over-heads"])
def test_no_all_gather_moves_the_cache(reference, port, hk):
    from repro_torch.launch.dryrun import kv_cache_gather_bytes

    coll = port[hk].collectives
    assert kv_cache_gather_bytes(coll, D) == 0
    blocks = {T, T // MESH[1]}
    ours = [c for c in coll if c.kind == "all-gather"
            and blocks & set(c.shape)]
    assert all(c.dtype == torch.bool for c in ours)
    theirs = 0
    for dtype, shape in reference[hk]["all_gathers"]:
        if blocks & set(shape):
            assert dtype == "pred"
            n = _BYTES[dtype]
            for s in shape:
                n *= s
            theirs += n
    assert sum(c.nbytes for c in ours) == theirs
    assert (theirs > 0) == (hk % MESH[1] == 0)
    if hk % MESH[1]:
        # the softmax over T: the row max, its sum and P·V cross the
        # model ranks, and nothing larger than a rank's (B_loc, 1, H, D)
        model = tuple(range(MESH[1]))
        reduces = [c for c in coll if c.kind == "all-reduce"
                   and c.ranks == model and c.dtype == torch.float32
                   and len(c.shape) in (4, 5)]
        assert len(reduces) == 3
        assert max(c.nbytes for c in reduces) == (B // MESH[0]) * H * D * 4


def test_plain_decode_is_unchanged_by_the_layout():
    """On plain tensors ``cached_attention`` is ``_attend`` itself, bit
    for bit, with and without a mask."""
    from repro_torch.models import attention as attn

    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 4, 8), generator=g)
    k = torch.randn((2, 16, 2, 8), generator=g)
    v = torch.randn((2, 16, 2, 8), generator=g)
    mask = torch.rand((2, 1, 1, 1, 16), generator=g) > 0.3
    for m in (mask, None):
        got = attn.cached_attention(q, k, v, m, 8)
        scores = attn._grouped_scores(q, k) / 8 ** 0.5
        if m is not None:
            scores = torch.where(m, scores, attn.NEG_INF)
        probs = torch.softmax(scores.to(torch.float32), dim=-1)
        assert torch.equal(got, attn._grouped_out(probs, v))


class _Stop(Exception):
    pass


def _handed_on(q, k, v, mask, done: list):
    """What ``_attend`` on one block of T hands to its next ``reduce``,
    the earlier reductions' results over every block being ``done``."""
    from repro_torch.models import attention as attn

    seen = []

    def reduce(t, op):
        seen.append(t)
        if len(seen) > len(done):
            raise _Stop
        return done[len(seen) - 1]

    with pytest.raises(_Stop):
        attn._attend(q, k, v, mask, q.shape[-1], reduce)
    return seen[-1]


def test_the_softmax_split_over_t_equals_the_whole():
    """``_attend`` over four blocks of T, each reduction (the row max, the
    sum, P·V) folded over the blocks as the all-reduces fold it, equals
    the whole softmax within float32 rounding; a block whose slots are
    all masked adds nothing."""
    from repro_torch.models import attention as attn

    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 1, 4, 8), generator=g)
    k = torch.randn((2, 16, 2, 8), generator=g)
    v = torch.randn((2, 16, 2, 8), generator=g)
    mask = torch.rand((2, 1, 1, 1, 16), generator=g) > 0.3
    mask[..., 4:8] = False                       # block 1: no valid slot
    mask[..., 0] = True
    whole = attn._attend(q, k, v, mask, 8)
    blocks = [slice(4 * i, 4 * i + 4) for i in range(4)]
    done = []
    for op in ("max", "sum", "sum"):
        parts = torch.stack([_handed_on(q, k[:, b], v[:, b], mask[..., b],
                                        done) for b in blocks])
        done.append(parts.amax(0) if op == "max" else parts.sum(0))
    assert done[2].shape == whole.shape
    assert torch.allclose(done[2], whole, rtol=1e-5, atol=1e-6)
