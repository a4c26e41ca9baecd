"""The training step: loss -> grads -> (optional compression) -> AdamW
(counterpart of ``repro.train.train_step``).

Gradients come from ``torch.autograd.grad`` on detached copies of the
state's leaves (views, not copies of the data), so the state itself holds
no autograd graph.  ``accum_steps > 1`` splits the batch on axis 0 and
averages loss and float32 gradients over the micro-batches in order, as
the reference's ``lax.scan``: activation memory scales with the
micro-batch while the optimizer sees the whole batch.  The optional
error-feedback compression hook (``distributed.compression``) transforms
the gradients before the update.

The state is donated, as the reference's step donates it
(``donate_argnums=(0,)``): the step writes the new parameters, moments,
step counts and compression residual into the storages of the old ones.
A caller that needs a state from before a step clones it first.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.train.optimizer import (
    AdamWConfig, OptState, adamw_init, adamw_update)
from repro_torch.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor
    compress_error: Optional[dict] = None   # error-feedback residual


def init_train_state(params, compress: bool = False) -> TrainState:
    err = tree_map(torch.zeros_like, params) if compress else None
    opt = adamw_init(params)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros_like(opt.step), compress_error=err)


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``; a leaf the loss
    does not reach gets a zero gradient, as in JAX."""
    flat = leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in flat]
        loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    accum_steps: int = 1,
                    compressor=None) -> Callable:
    """loss_fn(params, batch) -> scalar.  Returns step(state, batch) ->
    (state, metrics) with metrics ``loss``, ``grad_norm`` and ``lr``.

    The state is donated: the returned state's tensors are the caller's
    own, updated in place, so the caller's old state is the new one after
    the call (``adamw_update``)."""

    def step(state: TrainState, batch):
        if accum_steps > 1:
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            split = tree_map(lambda x: x.reshape(
                (accum_steps, x.shape[0] // accum_steps) + x.shape[1:]),
                batch)
            for i in range(accum_steps):
                mb = tree_map(lambda x: x[i], split)
                mloss, mgrads = value_and_grad(loss_fn, state.params, mb)
                grads = tree_map(
                    lambda a, g: a + g.to(torch.float32) / accum_steps,
                    grads, mgrads)
                loss = loss + mloss / accum_steps
        else:
            loss, grads = value_and_grad(loss_fn, state.params, batch)

        if compressor is not None:
            grads, err = compressor(grads, state.compress_error)
            with torch.no_grad():
                for old, new in zip(leaves(state.compress_error),
                                    leaves(err)):
                    old.copy_(new)
            del err

        _, _, metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        state.step.add_(1)
        return state, dict(metrics, loss=loss)

    return step
