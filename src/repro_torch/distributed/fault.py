"""Fault tolerance: failure simulation, elastic re-mesh, straggler policy
(counterpart of ``repro.distributed.fault``; numpy only).

On a real fleet the runtime signals are heartbeat timeouts and link
errors; here the same control flow is driven by a :class:`FailureInjector`
so every path is testable on CPU:

* **checkpoint/restart** — trainer saves atomically every N steps; on
  (injected) failure the trainer recomputes the mesh shape for the
  surviving device count and restores the last committed checkpoint (the
  single-host trainer onto its one device, as the reference's; sharded
  state reshards onto the new mesh through
  ``train.checkpoint.restore(..., shardings=)`` with the layouts of
  ``distributed.sharding``).
* **elastic re-mesh** — :func:`best_mesh_shape` picks the largest valid
  (data, model) grid for the surviving chips, keeping the model axis intact
  first (TP size is fixed by weight shapes), then shrinking data parallelism.
  Global batch is preserved by raising gradient-accumulation steps.
* **straggler mitigation** — the OLA engine's global chunk queue is already
  straggler-proof (slow workers claim fewer chunks; DESIGN.md §3); for
  training, :func:`rebalance_accum` adjusts per-host microbatch counts from
  observed step times (simulated in tests).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/examples."""

    fail_at_steps: tuple = ()
    kill_devices: int = 0
    _tripped: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> Optional[int]:
        """Returns surviving device delta if a failure fires at this step."""
        if step in self.fail_at_steps and step not in self._tripped:
            self._tripped.add(step)
            return self.kill_devices
        return None


def best_mesh_shape(n_devices: int, model_axis: int,
                    pod_axis: int = 1) -> tuple:
    """Largest (pod, data, model) grid for the surviving chip count.

    The model axis is load-bearing (weight shard shapes) so it is preserved;
    data parallelism absorbs the loss.  Raises if fewer than one model group
    survives.
    """
    per_pod = n_devices // max(pod_axis, 1)
    data = per_pod // model_axis
    if data < 1:
        # not enough chips for one model replica in each pod: collapse pods
        pod_axis = 1
        data = n_devices // model_axis
    if data < 1:
        raise RuntimeError(
            f"cannot fit model axis {model_axis} on {n_devices} devices")
    if pod_axis > 1:
        return (pod_axis, data, model_axis)
    return (data, model_axis)


def preserved_global_batch(global_batch: int, old_data: int,
                           new_data: int) -> tuple[int, int]:
    """(per_step_batch, accum_steps) preserving the optimizer-visible batch
    after data-parallel shrink."""
    if global_batch % new_data != 0:
        # round batch down to a shardable size (documented drift)
        global_batch = (global_batch // new_data) * new_data
    accum = max(int(np.ceil(old_data / new_data)), 1)
    return global_batch, accum


def rebalance_accum(step_times_per_host: np.ndarray,
                    base_accum: int) -> np.ndarray:
    """Straggler-aware microbatch counts: hosts slower than the median get
    proportionally fewer microbatches (work stays globally constant)."""
    t = np.asarray(step_times_per_host, np.float64)
    speed = np.median(t) / np.maximum(t, 1e-9)
    raw = base_accum * speed
    out = np.maximum(np.round(raw / raw.mean() * base_accum), 1).astype(int)
    return out
