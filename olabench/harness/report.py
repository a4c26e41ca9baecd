"""A run's result line: the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``), the device, and the check."""

from __future__ import annotations

import torch

from harness import spec

def _top(pairs, n: int = 10) -> list:
    """The ``n`` largest, names cut to 120 characters (a device kernel's
    name spells out all its template arguments)."""
    return [[k[:120], v] for k, v in sorted(pairs, key=lambda kv: -kv[1])[:n]]


def result(cell, res: dict, trace: bool) -> dict:
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m)(res["record"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": res["peak_bytes"]}
    out = {"correct": res["verdict"]["correct"],
           "attempted": res["attempted"],
           "failed": res["verdict"]["numbers"]["unanswered"]["value"],
           "metrics": metrics, "device": device}
    prof = res["record"]["profile"]
    if trace and prof is not None:
        device.update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
        out["breakdown"] = {
            "device_ops": _top((k, v[0]) for k, v in prof["ops"].items()),
            "idle_gaps": _top(prof["idle_gaps"].items())}
    out["window"] = res["window"]
    out["setup_phases"] = res["setup_phases"]
    out["checks"] = res["verdict"]["numbers"]
    return out
