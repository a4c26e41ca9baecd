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


def attention_heads(x, kv_heads: int, q, k, v):
    """DTensors ``q``, ``k``, ``v`` (B, S|T, H, D) of the attention on
    input ``x`` (B, S, d), in its per-rank layout: ``x``'s batch sharding,
    and on the tensor-parallel mesh dim the reference's rules (``q_heads``
    over the model axis, ``kv_heads`` replicated): the KV heads split when
    the axis divides their count (each rank's query heads then read only
    its own KV heads), else whole on every rank, and the query heads split
    either way (their count is padded to a multiple of the axis).  Plain
    tensors are returned as they are."""
    if not isinstance(x, DTensor):
        return q, k, v
    mesh = x.device_mesh
    tp = tensor_dim(mesh)
    n = mesh.size(tp) if tp >= 0 else 1
    kv_split = kv_heads % n == 0
    q_split = kv_split or q.shape[2] % n == 0

    def layout(split: bool) -> tuple:
        return tuple(Shard(0) if _is_batch(p)
                     else Shard(2) if md == tp and split else Replicate()
                     for md, p in enumerate(x.placements))

    return tuple(t if tuple(t.placements) == lay else t.redistribute(mesh, lay)
                 for t, lay in ((q, layout(q_split)), (k, layout(kv_split)),
                                (v, layout(kv_split))))


def attend(fn, q, k, v, mask):
    """``fn(q, k, v, mask)``; on DTensors (laid out by
    :func:`attention_heads`) on each rank's own batch rows and heads, since
    no step of attention reads another rank's rows or heads.

    Where the query heads are split on the tensor-parallel dim and the KV
    heads whole, each rank's query head ``h`` reads KV head ``h // G`` (G
    = query heads / KV heads): the rank selects those KV heads
    (``index_select``) and runs ``fn`` with one query head a KV head, so a
    rank whose heads straddle two groups needs no reshape of a group.  The
    K/V gradients are then partial sums over the tensor-parallel ranks."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, mask)
    from torch.distributed.tensor.experimental import local_map

    mesh, q_pl = q.device_mesh, tuple(q.placements)
    if not isinstance(mask, DTensor):
        mask = _replicated(mask, mesh)
    batch = tuple(p if _is_batch(p) else Replicate() for p in q_pl)
    tp = tensor_dim(mesh)
    if tp < 0 or q_pl[tp] != Shard(2) or k.placements[tp] == Shard(2):
        return local_map(fn, out_placements=(q_pl,),
                         in_placements=(q_pl, q_pl, q_pl, batch),
                         device_mesh=mesh, redistribute_inputs=True)(
            q, k, v, mask)
    kv_pl = tuple(Replicate() if md == tp else p for md, p in enumerate(q_pl))
    kv_grad = tuple(Partial() if md == tp else p for md, p in enumerate(q_pl))
    local = q.shape[2] // mesh.size(tp)
    first = mesh.get_local_rank(tp) * local
    groups = q.shape[2] // k.shape[2]
    heads = torch.arange(first, first + local, device=q.device) // groups

    def own_heads(ql, kl, vl, ml):
        return fn(ql, kl.index_select(2, heads), vl.index_select(2, heads),
                  ml)

    return local_map(own_heads, out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl, batch),
                     in_grad_placements=(q_pl, kv_grad, kv_grad, batch),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, mask)


def decode_attend(fn, q, k, v, mask):
    """``fn(q, k, v, mask, reduce)``: cached decode's attention of ``q``
    (B, 1, H, D) over the cache's ``k``, ``v`` (B, T, Hk, D) where
    ``mask`` (B, 1, 1, 1, T) holds (None: every slot).  ``reduce`` is
    None, or ``reduce(t, op)`` all-reduces ``t`` (``op`` "max" or "sum")
    over the ranks that hold the other blocks of T, so that ``fn`` splits
    its softmax over T.

    On DTensors each rank computes on its own block of the cache, which
    never moves: the layout is the cache's (its batch rows on the mesh
    dims that split them), and on the tensor-parallel mesh dim, by the
    cache's placement there (``launch/steps.py::_kv_cache_shardings``):

    * the KV heads (the axis divides their count): the query heads follow
      them, and the mask, sharded over T with the cached positions, is
      gathered over T (B_loc × T booleans);
    * T: the query heads are gathered (B_loc × H × D), each rank scores
      its own block of T under its own block of the mask, and ``reduce``
      all-reduces the softmax's row max, its sum and the output over the
      tensor-parallel ranks (``_c10d_functional`` collectives on the mesh
      dim's group, which the dry run's walk and ``CommDebugMode`` count
      alike);
    * neither (replicated): each rank computes its batch rows whole.

    The result has the query's heads in the layout ``fn`` saw them:
    split where the KV heads are, else whole."""
    if not isinstance(k, DTensor):
        return fn(q, k, v, mask, None)
    from torch.distributed.tensor.experimental import local_map

    mesh, kv_pl = k.device_mesh, tuple(k.placements)
    tp = tensor_dim(mesh)
    if any(p not in ((Shard(0), Replicate()) if md != tp else
                     (Shard(1), Shard(2), Replicate()))
           for md, p in enumerate(kv_pl)):
        raise ValueError(f"decode_attend: a cache laid out {kv_pl}")
    q_pl, m_pl = list(kv_pl), list(kv_pl)
    reduce = None
    if tp >= 0 and kv_pl[tp] == Shard(1):
        q_pl[tp], m_pl[tp] = Replicate(), Shard(4)
        group = mesh.get_group(tp).group_name
        ops = torch.ops._c10d_functional

        def reduce(t, op):
            return ops.wait_tensor(ops.all_reduce(t, op, group))
    elif tp >= 0:
        m_pl[tp] = Replicate()
    q_pl = tuple(q_pl)
    return local_map(lambda ql, kl, vl, ml: fn(ql, kl, vl, ml, reduce),
                     out_placements=(q_pl,),
                     in_placements=(q_pl, kv_pl, kv_pl,
                                    None if mask is None else tuple(m_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, mask)


class _VocabParallelCE(torch.autograd.Function):
    """The cross entropy's sums over a rank's own block of logits (B, S,
    V_loc), vocab columns ``lo`` on: the row max, the sum of ``exp`` and
    the label's logit all-reduced over ``vocab`` (a process group, None
    when the block holds the whole vocabulary), the loss and the valid
    count over ``batch`` (the groups of the mesh dims that split the
    rows).  Padded columns (``vocab_real`` on) are masked to -1e9 in the
    logits' dtype, as the plain loss masks them.  The backward is
    ``softmax - one_hot`` on the block, times the upstream gradient over
    the valid count, zero on padded columns: no collective."""

    @staticmethod
    def forward(ctx, logits, labels, lo, vocab_real, ignore_id, vocab, batch):
        ops = torch.ops._c10d_functional

        def reduce(t, op, groups):
            for g in groups:
                t = ops.wait_tensor(ops.all_reduce(t, op, g.group_name))
            return t

        width = logits.shape[-1]
        pad = lo + width > vocab_real
        x = logits
        if pad:
            cols = torch.arange(lo, lo + width, device=logits.device)
            x = torch.where(cols >= vocab_real,
                            torch.tensor(-1e9, dtype=logits.dtype,
                                         device=logits.device), x)
        x = x.to(torch.float32)
        valid = labels != ignore_id
        col = torch.where(valid, labels, torch.zeros_like(labels)).long() - lo
        mine = (col >= 0) & (col < width)
        col = col.clamp(0, width - 1)
        vocab = () if vocab is None else (vocab,)
        top = reduce(x.amax(-1), "max", vocab)
        total = reduce(torch.exp(x - top[..., None]).sum(-1), "sum", vocab)
        at_label = torch.take_along_dim(x, col[..., None], dim=-1)[..., 0]
        at_label = reduce(torch.where(mine, at_label, 0.0), "sum", vocab)
        ll = at_label - top - torch.log(total)
        num = reduce(-torch.sum(ll * valid), "sum", batch)
        count = reduce(torch.sum(valid), "sum", batch)
        ctx.save_for_backward(x, top, total, col, mine, valid, count)
        ctx.dtype, ctx.lo, ctx.vocab_real, ctx.pad = (
            logits.dtype, lo, vocab_real, pad)
        return num / torch.clamp(count, min=1)

    @staticmethod
    def backward(ctx, grad):
        x, top, total, col, mine, valid, count = ctx.saved_tensors
        out = torch.exp(x - top[..., None]).div_(total[..., None])
        out.scatter_add_(-1, col[..., None],
                         -mine[..., None].to(torch.float32))
        out.mul_((grad / torch.clamp(count, min=1) * valid)[..., None])
        if ctx.pad:
            cols = torch.arange(ctx.lo, ctx.lo + x.shape[-1], device=x.device)
            out.masked_fill_(cols >= ctx.vocab_real, 0.0)
        return out.to(ctx.dtype), None, None, None, None, None, None


def cross_entropy(logits: DTensor, labels, vocab_real: int,
                  ignore_id: int = -100):
    """The mean next-token cross entropy of DTensor ``logits`` (B, S,
    V_pad) over the valid positions of ``labels`` (B, S), padded vocab
    columns masked, vocab-parallel: each rank computes on its own block
    (batch rows where ``logits`` shards dim 0, vocab columns where the
    tensor-parallel mesh dim shards the last dim; any other placement is
    gathered first) and only per-row sums cross ranks, so no rank holds
    the global batch's or the whole vocabulary's logits, nor their
    gradient.  The loss is replicated."""
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    tp = tensor_dim(mesh)
    last = logits.dim() - 1
    lay, rows = [], []
    vocab, lo = None, 0
    for md, p in enumerate(logits.placements):
        if _is_batch(p):
            lay.append(Shard(0))
            rows.append(mesh.get_group(md))
        elif md == tp and isinstance(p, Shard) and p.dim in (-1, last):
            lay.append(Shard(last))
            # DTensor's split: blocks of ceil(V / n) columns, in rank order
            block = -(-logits.shape[-1] // mesh.size(md))
            vocab, lo = mesh.get_group(md), mesh.get_local_rank(md) * block
        else:
            lay.append(Replicate())
    lay = tuple(lay)
    lab = tuple(p if _is_batch(p) else Replicate() for p in lay)
    if not isinstance(labels, DTensor):
        labels = _replicated(labels, mesh)
    return local_map(
        lambda x, y: _VocabParallelCE.apply(x, y, lo, vocab_real, ignore_id,
                                            vocab, tuple(rows)),
        out_placements=(tuple(Replicate() for _ in lay),),
        in_placements=(lay, lab), in_grad_placements=(lay, lab),
        device_mesh=mesh, redistribute_inputs=True)(logits, labels)


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


def batch_rows(fn, like, *args):
    """``fn(*args)`` of tensors (B, ...) (or None) that read no other batch
    row; when ``like`` is a DTensor, on each rank's own rows of ``like``'s
    batch layout (a plain argument is taken as the whole batch, equal on
    every rank), the result (B, ...) in that layout: no rank builds the
    global batch's result (attention's mask)."""
    if not isinstance(like, DTensor):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = like.device_mesh
    rows = tuple(p if _is_batch(p) else Replicate() for p in like.placements)
    args = [a if a is None or isinstance(a, DTensor) else _replicated(a, mesh)
            for a in args]
    return local_map(fn, out_placements=(rows,),
                     in_placements=tuple(None if a is None else rows
                                         for a in args),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


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
