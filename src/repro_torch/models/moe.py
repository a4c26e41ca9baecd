"""Mixture-of-Experts layer: top-k routing with capacity-based scatter
dispatch (counterpart of ``repro.models.moe``).

Tokens are scattered into a ``(G, E, C + 1, d)`` buffer by (expert,
position-in-expert), the experts run as one batched SwiGLU product
``(G, E, C, d) x (E, d, f)`` (a cuBLAS batched matmul: the reference
computes it outside any Pallas kernel), and each token gathers its
experts' rows back, weighted by its renormalised gate values.  Tokens
beyond an expert's capacity land in the overflow row ``C``, which is
discarded: they contribute nothing.

The dispatch is integer state and equals the reference's:

* the top-k experts come from a stable descending sort of the router
  probabilities, so a tie puts the lower expert index first, as
  ``jax.lax.top_k`` does (``torch.topk`` leaves the order of ties
  unspecified);
* a token's position within its expert counts slot 0's tokens first, then
  slot 1's, each in token order (GShard's priority);
* ``capacity = max(int(capacity_factor * k * Tg / E), 4)``.

The group axis ``G`` is the reference's data groups, each routing its own
``Tg = T / G`` tokens with its own capacity: ``G`` comes from
``distributed.autoshard.data_group_count`` (1 outside a sharding scope,
the data axis' size inside one).  Under a scope the groups lie on the data
ranks (``constrain(xt, "btd")``, the buffer ``"gecd"``), and the
group-local steps (the dispatch, the scatter into the buffer, the combine)
run on each rank's own groups (``distributed/layout.py``): DTensor has
no sharding strategy for ``index_put_`` (nor for ``one_hot``), and these
steps need none, since a group never reaches another group's rows, which
is what the reference's ``vmap`` over groups proves to GSPMD.

Positions below ``C`` are unique within a (group, expert), so the kept
rows are written exactly in any order; the overflow row receives many
dropped tokens, written with ``index_put_`` and then cut off.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import layout
from repro_torch.distributed.autoshard import constrain, data_group_count
from repro_torch.models.layers import linear


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    return max(int(cfg.capacity_factor * cfg.top_k * tokens_per_group
                   / cfg.num_experts), 4)


def moe_dispatch(probs: torch.Tensor, k: int, cap: int):
    """The dispatch of router probabilities ``probs`` (G, Tg, E) float32:
    ``(gate_vals (G, Tg, k) renormalised, expert_idx (G, Tg, k) int64,
    pos (G, Tg, k) int64 with C for a dropped token, keep (G, Tg, k)
    bool)``."""
    e = probs.shape[-1]
    top, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = top[..., :k]
    expert_idx = expert_idx[..., :k]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, -1, keepdim=True), min=1e-9)
    pos_list, keep_list = [], []
    counts = torch.zeros(probs.shape[0], e, dtype=torch.int64,
                         device=probs.device)
    for slot in range(k):
        ei = expert_idx[..., slot]                              # (G, Tg)
        oh = F.one_hot(ei, e)                                   # (G, Tg, E)
        pos_in = torch.cumsum(oh, dim=1) - oh
        pos = torch.take_along_dim(pos_in, ei[..., None], dim=2)[..., 0]
        pos = pos + torch.take_along_dim(counts, ei, dim=1)
        keep = pos < cap
        pos_list.append(torch.where(keep, pos, cap))
        keep_list.append(keep)
        counts = counts + oh.sum(dim=1)
    return (gate_vals, expert_idx, torch.stack(pos_list, -1),
            torch.stack(keep_list, -1))


def _scatter(xt: torch.Tensor, expert_idx: torch.Tensor, pos: torch.Tensor,
             e: int, cap: int) -> torch.Tensor:
    """Tokens ``xt (G, Tg, d)`` into their ``(G, E, C, d)`` buffer rows
    (the overflow row ``C`` written, then cut off)."""
    groups, _, d = xt.shape
    gi = torch.arange(groups, device=xt.device)[:, None]
    buf = torch.zeros((groups, e, cap + 1, d), dtype=xt.dtype,
                      device=xt.device)
    for slot in range(expert_idx.shape[-1]):
        buf.index_put_((gi, expert_idx[..., slot], pos[..., slot]), xt)
    return buf[:, :, :cap]


def _combine(out_buf: torch.Tensor, expert_idx: torch.Tensor,
             pos: torch.Tensor, gate_vals: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Each token's experts' rows of ``out_buf (G, E, C, d)``, weighted by
    its kept gate values: ``(G, Tg, d)``."""
    groups, e, _, d = out_buf.shape
    gi = torch.arange(groups, device=out_buf.device)[:, None]
    out_buf = torch.cat([out_buf, out_buf.new_zeros(groups, e, 1, d)], dim=2)
    out = torch.zeros(expert_idx.shape[:2] + (d,), dtype=out_buf.dtype,
                      device=out_buf.device)
    for slot in range(expert_idx.shape[-1]):
        piece = out_buf[gi, expert_idx[..., slot], pos[..., slot]]
        w = (gate_vals[..., slot] * keep[..., slot]).to(out_buf.dtype)
        out = out + piece * w[..., None]
    return out


def _expert_counts(expert_idx: torch.Tensor, e: int) -> torch.Tensor:
    """``(G, k, E)`` float32 count of each group's tokens a slot routes to
    each expert."""
    return F.one_hot(expert_idx, e).to(torch.float32).sum(dim=1)


def _swiglu_experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.matmul(buf, wg)) * torch.matmul(buf, wu)
    return torch.matmul(h, wd)                                  # (G, E, C, d)


def moe_apply(p: dict, cfg: MoEConfig, x: torch.Tensor,
              return_aux: bool = False):
    """x (B, S, d) -> (B, S, d) [, aux loss (float32 scalar)].

    ``p``: ``router (d, E)``, ``gate``/``up (E, d, f)``, ``down (E, f,
    d)``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    groups = data_group_count(b * s)
    tg = b * s // groups
    xt = constrain(x.reshape(groups, tg, d), "btd")     # groups → data

    logits = linear(xt, p["router"])                            # (G, Tg, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    cap = capacity(cfg, tg)
    gate_vals, expert_idx, pos, keep = layout.group_local(
        lambda pr: moe_dispatch(pr, k, cap), xt, 4, probs)
    buf = layout.group_local(lambda *a: _scatter(*a, e, cap), xt, 1,
                       xt, expert_idx, pos)
    buf = constrain(buf, "gecd")   # groups → data; experts → model if divisible

    out_buf = layout.expert_ffn(_swiglu_experts, buf,
                                *(p[n].to(x.dtype)
                                  for n in ("gate", "up", "down")))
    out = layout.group_local(_combine, xt, 1, out_buf, expert_idx, pos, gate_vals,
                       keep).reshape(b, s, d)
    if not return_aux:
        return out
    # Switch-style load-balancing loss: E · Σ_e fraction_e · router_prob_e
    # the mean over (G, Tg) of each slot's one-hot routing, from each
    # group's integer counts (exact in float32)
    counts = layout.group_local(lambda i: _expert_counts(i, e), xt, 1,
                          expert_idx).sum(dim=0)                # (k, E)
    frac = sum(counts[slot] / float(groups * tg) for slot in range(k))
    frac = frac / k
    mean_prob = torch.mean(probs, dim=(0, 1))
    return out, e * torch.sum(frac * mean_prob)
