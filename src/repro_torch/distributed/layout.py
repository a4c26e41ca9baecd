"""Per-rank layouts of the models' sharded steps (DTensor).

Where DTensor's own sharding propagation would pick a layout, the models
call these helpers, which pick it from the mesh's roles and run the plain
step on each rank's own blocks (``local_map``):

* the tensor-parallel mesh dim is the one the sharding rules put the heads
  and FFN dims on (:attr:`ShardingRules.tensor_axis` of ``DEFAULT_RULES``,
  the only rules that shard a weight): a weight keeps its block there
  (row-, column- or expert-parallel);
* on every other mesh dim a weight is gathered (FSDP: weights move, never
  the batch) and the activations keep their batch sharding.

Layouts are chosen rather than propagated because DTensor's view rules on
torch 2.11 refuse to merge a sharded dim with another or to split one
unevenly (attention's grouped einsums flatten batch × heads; smollm's 5 KV
heads of 64 on a 2-way model axis), its matmul strategies plan the MoE's
batched expert product through ``_StridedShard`` layouts whose
redistribution planner dominated the step, and some ops have no strategy
at all (``index_put_``, ``one_hot``, ``log_sigmoid_backward``).

Every helper but :func:`contract` and :func:`embedding` (which the models
call on DTensor weights only) takes plain tensors too, and then runs the
plain step alone.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import DEFAULT_RULES, ShardingRules
from repro_torch.tree import leaves, unflatten


def tensor_axis() -> Optional[str]:
    """The mesh axis of tensor parallelism under ``DEFAULT_RULES``."""
    return ShardingRules(rules=DEFAULT_RULES).tensor_axis


def tensor_dim(mesh) -> int:
    """The index of ``mesh``'s tensor-parallel dim, -1 when it has none."""
    names = tuple(mesh.mesh_dim_names or ())
    axis = tensor_axis()
    return names.index(axis) if axis in names else -1


def _replicated(t: torch.Tensor, mesh) -> DTensor:
    """A plain tensor equal on every rank as a replicated DTensor."""
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _is_batch(p) -> bool:
    return isinstance(p, Shard) and p.dim == 0


def _flat_contract(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """x's last ``k`` dims contracted with w's first ``k``."""
    inner = 1
    for n in w.shape[:k]:
        inner *= n
    out = torch.matmul(x.reshape(x.shape[:-k] + (inner,)),
                       w.reshape(inner, -1))
    return out.reshape(x.shape[:-k] + w.shape[k:])


def contract(x, w: DTensor, k: int):
    """``x``'s last ``k`` dims contracted with DTensor ``w``'s first ``k``
    on each rank's own blocks.

    On the tensor-parallel mesh dim the weight keeps its placement:
    sharded on a contracted dim (row-parallel), ``x`` is sharded there too
    and the product is a partial sum; sharded on an output dim
    (column-parallel), ``x`` is whole there and the product sharded on
    that dim.  On every other mesh dim the weight is gathered and ``x``
    keeps its batch sharding.  Gradients: the weight's are partial sums
    over the ranks that hold other batch rows, ``x``'s over the ranks that
    hold other output columns."""
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = _replicated(x, mesh)
    tp = tensor_dim(mesh)
    lead = x.dim() - k
    x_pl, w_pl, o_pl, xg_pl, wg_pl = [], [], [], [], []
    for md, (px, pw) in enumerate(zip(x.placements, w.placements)):
        batch = _is_batch(px) and lead > 0
        keep = md == tp and isinstance(pw, Shard)
        if keep and pw.dim < k:                  # row-parallel
            x_pl.append(Shard(lead + pw.dim))
            o_pl.append(Partial())
            xg_pl.append(Shard(lead + pw.dim))
            w_pl.append(pw)
            wg_pl.append(pw)
        elif keep:                               # column-parallel
            x_pl.append(Replicate())
            o_pl.append(Shard(lead + pw.dim - k))
            xg_pl.append(Partial())
            w_pl.append(pw)
            wg_pl.append(pw)
        else:
            x_pl.append(Shard(0) if batch else Replicate())
            o_pl.append(Shard(0) if batch else Replicate())
            xg_pl.append(Shard(0) if batch else Replicate())
            w_pl.append(Replicate())
            wg_pl.append(Partial() if batch else Replicate())
    return local_map(lambda a, b: _flat_contract(a, b, k),
                     out_placements=(tuple(o_pl),),
                     in_placements=(tuple(x_pl), tuple(w_pl)),
                     in_grad_placements=(tuple(xg_pl), tuple(wg_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def embedding(table: DTensor, tokens: torch.Tensor):
    """Rows ``tokens`` of DTensor ``table``: the table's vocab sharding is
    dropped first (an all-gather over the vocab's mesh dim; its d_model
    sharding stays), then ``F.embedding``.  DTensor's masked lookup on a
    vocab-sharded table breaks on a mesh of more than one dim (its mask
    covers the local tokens, its output the gathered ones)."""
    keep = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
            for p in table.placements]
    return F.embedding(tokens.long(),
                       table.redistribute(table.device_mesh, keep))


def attention_heads(x, kv_heads: int, *ts):
    """DTensors ``ts`` (B, S|T, H, D) of the attention on input ``x``
    (B, S, d), in its per-rank layout: ``x``'s batch sharding, and the
    heads on the tensor-parallel mesh dim when its size divides the KV
    head count (each rank's query heads then read only its own KV heads),
    else whole.  Plain tensors are returned as they are."""
    if not isinstance(x, DTensor):
        return ts
    mesh = x.device_mesh
    tp = tensor_dim(mesh)
    layout = tuple(
        Shard(0) if _is_batch(p)
        else Shard(2) if md == tp and kv_heads % mesh.size(md) == 0
        else Replicate()
        for md, p in enumerate(x.placements))
    return tuple(t if tuple(t.placements) == layout
                 else t.redistribute(mesh, layout) for t in ts)


def attend(fn, q, k, v, mask):
    """``fn(q, k, v, mask)``; on DTensors (laid out by
    :func:`attention_heads`) on each rank's own batch rows and heads, since
    no step of attention reads another rank's rows or heads."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, mask)
    from torch.distributed.tensor.experimental import local_map

    mesh, layout = q.device_mesh, tuple(q.placements)
    if not isinstance(mask, DTensor):
        mask = _replicated(mask, mesh)
    batch = tuple(p if _is_batch(p) else Replicate() for p in layout)
    return local_map(fn, out_placements=(layout,),
                     in_placements=(layout, layout, layout, batch),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, mask)


def write_slots(buf, bi: torch.Tensor, slot: torch.Tensor, val) -> None:
    """``buf[bi, slot] = val`` in place, ``bi`` every batch row of ``buf
    (B, T, ...)``.  A DTensor cache has no sharding strategy for
    ``index_put_``; each rank writes its own block instead: ``val`` and
    ``slot`` are redistributed to the cache's batch and head layout, and
    where the cache shards its ``T`` dim, the rank holding a row's slot
    writes it."""
    if not isinstance(buf, DTensor):
        buf.index_put_((bi, slot), val)
        return
    mesh, pl = buf.device_mesh, buf.placements
    shard = [p.dim if isinstance(p, Shard) else None for p in pl]
    val_pl = [Replicate() if d in (None, 1) else Shard(d - (d > 1))
              for d in shard]
    slot_pl = [Shard(0) if d == 0 else Replicate() for d in shard]
    v = val.redistribute(mesh, val_pl).to_local()
    s = slot.redistribute(mesh, slot_pl).to_local()
    local = buf.to_local()
    lo = 0
    for md, d in enumerate(shard):
        if d == 1:
            lo += mesh.get_local_rank(md) * local.shape[1]
    s = s - lo
    # a row whose slot another rank holds writes its own value back at a
    # slot of this block: no data-dependent shapes (the dry run's meta
    # tensors have no values)
    ok = (s >= 0) & (s < local.shape[1])
    s = s.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = ok.reshape(ok.shape + (1,) * (v.dim() - 1))
    local.index_put_((rows, s), torch.where(keep, v, local[rows, s]))


def expert_ffn(fn, buf, wg, wu, wd):
    """``fn(buf, wg, wu, wd)``, the batched expert FFN ``(G, E, C, d) x
    (E, d, f)``; on DTensors each rank computes its own block.

    The weights are gathered on every mesh dim but the tensor-parallel
    one, where they keep their experts (expert-parallel) or their FFN dim
    sharded.  The buffer keeps its groups on the data ranks and, with the
    experts sharded, its experts on the same ranks as the weights.  A
    rank's products then need no other rank's rows; with the FFN dim
    sharded, ``down`` leaves a partial sum on that mesh dim, reduced where
    the combine redistributes it."""
    if not isinstance(buf, DTensor):
        return fn(buf, wg, wu, wd)
    from torch.distributed.tensor.experimental import local_map

    m = tensor_dim(buf.device_mesh)
    w_pl = [tuple(p if md == m else Replicate()
                  for md, p in enumerate(w.placements))
            for w in (wg, wu, wd)]
    on_model = w_pl[0][m] if m >= 0 else Replicate()
    ep = isinstance(on_model, Shard) and on_model.dim == 0
    tp = isinstance(on_model, Shard) and on_model.dim == 2
    b_pl = tuple((Shard(1) if ep else Replicate()) if md == m else p
                 for md, p in enumerate(buf.placements))
    o_pl = tuple(Partial() if md == m and tp else p
                 for md, p in enumerate(b_pl))
    # gradients: the buffer's on the FFN-sharded dim (its output's
    # layout) and the weights' on the ranks that gathered them are
    # partial sums
    b_grad = o_pl
    w_grad = [tuple(p if md == m else Partial() for md, p in enumerate(pl))
              for pl in w_pl]
    return local_map(fn, out_placements=(o_pl,),
                     in_placements=(b_pl, *w_pl),
                     in_grad_placements=(b_grad, *w_grad),
                     device_mesh=buf.device_mesh,
                     redistribute_inputs=True)(buf, wg, wu, wd)


def group_local(fn, like, n_out: int, *args):
    """``fn(*args)``; when ``like`` is a DTensor, on each rank's own groups
    (dim 0 in ``like``'s layout, every tensor argument redistributed to
    it), the ``n_out`` outputs in that layout."""
    if not isinstance(like, DTensor):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    layout = tuple(like.placements)
    in_p = tuple(layout if isinstance(a, torch.Tensor) else None
                 for a in args)
    return local_map(fn, out_placements=(layout,) * n_out, in_placements=in_p,
                     device_mesh=like.device_mesh,
                     redistribute_inputs=True)(*args)


def batch_local(fwd):
    """``fwd(params, cfg, x)`` of a block whose parameters are replicated
    and which reads no other batch row: on a DTensor ``x``, run on each
    rank's own rows, a parameter's gradient a partial sum over the ranks
    that hold other rows; on a plain ``x``, ``fwd`` itself."""
    def run(bp: dict, cfg, x):
        if not isinstance(x, DTensor):
            return fwd(bp, cfg, x)
        from torch.distributed.tensor.experimental import local_map

        flat = leaves(bp)
        batch = tuple(x.placements)
        rep = tuple(Replicate() for _ in batch)
        grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                     for p in batch)
        return local_map(
            lambda xl, *ps: fwd(unflatten(bp, list(ps)), cfg, xl),
            out_placements=(batch,),
            in_placements=(batch,) + (rep,) * len(flat),
            in_grad_placements=(batch,) + (grad,) * len(flat),
            device_mesh=x.device_mesh, redistribute_inputs=True)(x, *flat)

    return run
