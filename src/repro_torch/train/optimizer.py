"""AdamW with warmup-cosine schedule and global-norm clipping (counterpart
of ``repro.train.optimizer``).

Hand-rolled, as the reference: the moments are trees of the parameters'
shape and dtype on the parameters' device.  The step count, learning rate,
bias corrections and clip scale are float32 tensors, computed in the
reference's order, so the schedule matches it within two ulps; each leaf
is updated in one pass (the reference's three passes over the tree only
keep JAX's un-zipping of tuple leaves unambiguous), in place: the
counterpart of the reference's donated state (``donate_argnums=(0,)``),
whose new parameters and moments XLA writes into the old buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    mu: dict
    nu: dict
    step: torch.Tensor


def _device(tree):
    flat = leaves(tree)
    return flat[0].device if flat else None


def adamw_init(params) -> OptState:
    zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
    return OptState(mu=zeros(), nu=zeros(),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=_device(params)))


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    # a correctly rounded cosine of the float32 angle: torch's float32 cos
    # is off by an ulp on many angles, and ``1 + cos`` near the schedule's
    # end magnifies that into several ulps of the rate
    angle = math.pi * progress
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(angle.to(torch.float64)).to(torch.float32))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt: OptState):
    """-> (params, opt, metrics), the state updated in place.

    The counterpart of the reference's donated update: each leaf's new
    parameter, ``mu`` and ``nu`` are written into the storage of the old
    one (``copy_``), leaf by leaf, so that at most one leaf's temporaries
    are live at a time and no second state is built.  Each value is the
    out-of-place formula's, expression by expression, bit for bit.  The
    returned trees are ``params``, ``opt.mu`` and ``opt.nu`` themselves;
    ``opt.step`` is advanced in place too."""
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                        device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = opt.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt.mu),
                          leaves(opt.nu)):
        if isinstance(p, DTensor) and g.placements != p.placements:
            # a sharded parameter's gradient in the parameter's layout
            # (a partial sum reduced, a replicated one split), so the
            # update and both moments keep that layout
            g = g.redistribute(p.device_mesh, p.placements)
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        del g
        # mhat = m / b1c and vhat = v / b2c inline: each temporary dies
        # as soon as the next operation has read it
        p.copy_((p - lr * (m / b1c / (torch.sqrt(v / b2c) + cfg.eps)
                           + cfg.weight_decay * p)).to(p.dtype))
    opt.step.copy_(step)
    return params, opt, {"grad_norm": gnorm, "lr": lr}
