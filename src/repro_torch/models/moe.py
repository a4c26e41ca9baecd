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
``Tg = T / G`` tokens with its own capacity.  Outside a sharding scope the
reference's group count is 1, and the port has no sharding scope yet: G =
1, the axis kept so that a group count can be set without a new layout.

Positions below ``C`` are unique within a (group, expert), so the kept
rows are written exactly in any order; the overflow row receives many
dropped tokens, written with ``index_put_`` and then cut off.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

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


def moe_apply(p: dict, cfg: MoEConfig, x: torch.Tensor,
              return_aux: bool = False):
    """x (B, S, d) -> (B, S, d) [, aux loss (float32 scalar)].

    ``p``: ``router (d, E)``, ``gate``/``up (E, d, f)``, ``down (E, f,
    d)``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    groups, tg = 1, b * s
    xt = x.reshape(groups, tg, d)

    logits = linear(xt, p["router"])                            # (G, Tg, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    cap = capacity(cfg, tg)
    gate_vals, expert_idx, pos, keep = moe_dispatch(probs, k, cap)

    gi = torch.arange(groups, device=x.device)[:, None]
    buf = torch.zeros((groups, e, cap + 1, d), dtype=x.dtype, device=x.device)
    for slot in range(k):
        buf.index_put_((gi, expert_idx[..., slot], pos[..., slot]), xt)
    buf = buf[:, :, :cap]

    wg, wu, wd = (p[n].to(x.dtype) for n in ("gate", "up", "down"))
    h = F.silu(torch.matmul(buf, wg)) * torch.matmul(buf, wu)
    out_buf = torch.matmul(h, wd)                               # (G, E, C, d)
    out_buf = torch.cat([out_buf, out_buf.new_zeros(groups, e, 1, d)], dim=2)

    out = torch.zeros((groups, tg, d), dtype=x.dtype, device=x.device)
    for slot in range(k):
        piece = out_buf[gi, expert_idx[..., slot], pos[..., slot]]
        w = (gate_vals[..., slot] * keep[..., slot]).to(x.dtype)
        out = out + piece * w[..., None]
    out = out.reshape(b, s, d)
    if not return_aux:
        return out
    # Switch-style load-balancing loss: E · Σ_e fraction_e · router_prob_e
    frac = torch.zeros(e, dtype=torch.float32, device=x.device)
    for slot in range(k):
        frac = frac + torch.mean(
            F.one_hot(expert_idx[..., slot], e).to(torch.float32), dim=(0, 1))
    frac = frac / k
    mean_prob = torch.mean(probs, dim=(0, 1))
    return out, e * torch.sum(frac * mean_prob)
