"""Variance-guided chunk claim ordering (counterpart of
``repro.sched.claims``).

The engine claims chunks in a committed random schedule.  For correctness
only the *first-touch* order matters: the set of started chunks must always
be a prefix of the committed order (§4.2), so sample inclusion never
depends on content.  The order in which started chunks are *revisited*
(top-up passes, schedules rewound behind re-opened work) is free, and
claiming the chunks with the highest within-chunk variance across the live
slots first shrinks the dominant CI terms soonest (Neyman allocation,
applied to claim order).

:func:`variance_claim_order` permutes only the unclaimed tail of the
schedule (positions ≥ head), in three bands:

1. never-started chunks, in their committed order;
2. started-and-open chunks, by measured aggregate variance, descending;
3. closed or exhausted chunks last.

The server writes the result into the engine state *before* the round's
claim prediction, so the streaming prefetcher and the round's CLAIM follow
the same order.  The state may hold numpy arrays or tensors; a tensor
state is read with one device-to-host copy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(parts) -> list[np.ndarray]:
    """``parts`` as float64 numpy arrays: tensors in one device-to-host
    copy (int32 and float32 values are exact in float64), anything else
    through ``numpy.asarray``."""
    if not all(isinstance(p, torch.Tensor) for p in parts):
        return [np.asarray(p, np.float64) for p in parts]
    flat = torch.cat([p.reshape(-1).to(torch.float64) for p in parts])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(tuple(p.shape)))
        at += p.numel()
    return out


def _variances(m: np.ndarray, ys: np.ndarray, yq: np.ndarray,
               active: Optional[np.ndarray],
               slot_need: Optional[np.ndarray]) -> np.ndarray:
    if m.ndim == 1:
        # frozen plane: the (N,) sample size is shared by every query row
        m = np.broadcast_to(m[None], ys.shape)
    ss = yq - np.where(m > 0, ys * ys / np.maximum(m, 1.0), 0.0)
    v = np.where(m >= 2, np.maximum(ss / np.maximum(m - 1.0, 1.0), 0.0), 0.0)
    if active is not None:
        active = np.asarray(active, bool)
        if active.shape[0] != v.shape[0]:
            raise ValueError(
                f"active mask length {active.shape[0]} does not match the "
                f"stats plane's leading dim {v.shape[0]}")
        v = v * active[:, None]
    if slot_need is not None:
        need = np.asarray(slot_need, np.float64)
        if need.shape[0] != v.shape[0]:
            raise ValueError(
                f"slot_need length {need.shape[0]} does not match the "
                f"stats plane's leading dim {v.shape[0]}")
        return (v * need[:, None]).sum(axis=0)
    return v.max(axis=0)


def slot_chunk_variances(state, active: Optional[np.ndarray] = None,
                         slot_need: Optional[np.ndarray] = None,
                         ) -> np.ndarray:
    """Aggregate per-chunk within-variance across slots, ``(N,)``.

    The s²/m proxy of ``BiLevelSynopsis.within_variances``, masked to the
    live slots; chunks a slot has fewer than two tuples from contribute
    zero.  ``slot_need`` (``(S,)``, non-negative) weights each slot's plane
    by its remaining distance to its ε target, ``max(err/ε − 1, 0)``, and
    the aggregate becomes the need-weighted sum over slots; without it the
    key is the unweighted max over slots."""
    st = state.stats
    m, ys, yq = _host((st.m, st.ysum, st.ysq))
    return _variances(m, ys, yq, active, slot_need)


def variance_claim_order(state, chunk_sizes: np.ndarray,
                         active: Optional[np.ndarray] = None,
                         slot_need: Optional[np.ndarray] = None,
                         ) -> Optional[np.ndarray]:
    """New ``(N,)`` int32 schedule with the unclaimed tail variance-ordered,
    or ``None`` when the order is unchanged or there is nothing to reorder.
    Positions ``< head`` (claimed or done) never move.  ``slot_need``
    switches the key to the ε-distance-weighted aggregate (see
    :func:`slot_chunk_variances`)."""
    st = state.stats
    m, ys, yq, schedule, head, scan_m, closed = _host(
        (st.m, st.ysum, st.ysq, state.schedule, state.head, state.scan_m,
         state.closed))
    schedule = schedule.astype(np.int64)
    n = len(schedule)
    head = int(head)
    if head >= n - 1:
        return None
    tail = schedule[head:]
    sizes = np.asarray(chunk_sizes)
    v = _variances(m, ys, yq, active, slot_need)
    dead = closed[tail].astype(bool) | (scan_m[tail] >= sizes[tail])
    started = scan_m[tail] > 0
    band = np.where(dead, 2, np.where(started, 1, 0))
    if not (band == 1).any():
        # nothing measured in the tail: the committed order stands, modulo
        # dead chunks
        if not dead.any() or (band == 2).all():
            return None
    # lexsort: most significant key last; stability keeps band 0 in
    # committed order and band-1 ties deterministic
    order = np.lexsort((np.arange(len(tail)), -v[tail], band))
    new_tail = tail[order]
    if np.array_equal(new_tail, tail):
        return None
    out = schedule.copy()
    out[head:] = new_tail
    return out.astype(np.int32)
