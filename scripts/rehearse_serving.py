#!/usr/bin/env python3
"""Rehearse chip_smoke.py's serving-plane phases on the CPU at a small size.

    PYTHONPATH=src python scripts/rehearse_serving.py --tuples 65536 \
        --chunks 16 [--phases ptf,parity,sched,rollup] [--sched-rate R] \
        [--rollup-rate R] [--ptf-tuples N]

Runs ``phase_ptf``, ``phase_sched_parity``, ``phase_sched`` and
``phase_rollup`` of ``chip_smoke.py`` with every ``"cuda"`` read as
``"cpu"``: the kernel wrappers' plain versions stand in for the kernels
(each entry point of ``repro_torch.kernels.ops`` counted as a launch),
nothing is timed on a device, and the fresh-process kernel trace is
skipped.  Round counts, outcomes, tier-1 answers and the gates are the
smoke's own; times are the CPU's and say nothing of the card.

A small table's full scan is short in modeled time, so arrivals that
overlap at 8,388,608 tuples do not overlap here: scale the arrival rates
(``--sched-rate``, ``--rollup-rate``) by 8,388,608 / tuples to keep their
share of a full scan.  Never run it at the full 8,388,608 tuples on a
shared machine's CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.kernels import ops, ref as kref  # noqa: E402


def load_smoke_on_cpu():
    """chip_smoke.py as a module whose devices are the CPU."""
    path = os.path.join(REPO, "chip_smoke.py")
    with open(path) as f:
        src = f.read().replace('"cuda"', '"cpu"')
    mod = types.ModuleType("chip_smoke_cpu")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


class Counted:
    """A launch counter standing in for a kernel wrapper."""

    def __init__(self, name: str):
        self.__name__ = name + "_cuda"
        self.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tuples", type=int, default=65536)
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--phases", default="ptf,parity,sched,rollup")
    ap.add_argument("--sched-rate", type=float, default=None,
                    help="[sched] arrivals per modeled second")
    ap.add_argument("--rollup-rate", type=float, default=None,
                    help="[rollup] arrivals per modeled second")
    ap.add_argument("--ptf-tuples", type=int, default=131072)
    args = ap.parse_args(argv)

    smoke = load_smoke_on_cpu()
    for name in ("synchronize", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0

    counters = {n: Counted(n) for n in (
        "slot_extract", "slot_extract_stream", "slot_eval_decoded",
        "extract_parse", "slot_extract_grouped", "chunk_agg", "round_stats")}
    smoke.KERNELS = tuple(counters.values())
    for name, counter in counters.items():
        fn = getattr(ops, name, None)
        if fn is None:
            continue

        def counting(*a, _fn=fn, _c=counter, **k):
            _c.launches += 1
            return _fn(*a, **k)

        setattr(ops, name, counting)

    def plain_kernel1(packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate,
                      weights, return_cols=False):
        return kref.slot_extract_ref(packed, jw, idx, b_eff, coeffs, lo, hi,
                                     isc, gate, num_cols=coeffs.shape[1],
                                     return_cols=return_cols,
                                     weights=weights)

    smoke.slot_extract_cuda = plain_kernel1
    smoke.fresh_kernel1_trace = lambda inputs, rc, iters: dict(
        ms=None, per_call=1.0)
    smoke.time_cuda = lambda fn, iters: 0.0
    smoke.PTF_ASCII = dict(tuples=args.ptf_tuples, chunks=128)
    if args.sched_rate is not None:
        smoke.SCHED_RATE = args.sched_rate
    if args.rollup_rate is not None:
        smoke.ROLLUP_RATE = args.rollup_rate

    phases = args.phases.split(",")
    t0 = time.perf_counter()
    values, store = smoke.build_store(args.tuples, args.chunks,
                                      smoke.NUM_COLS)
    packed, _ = store.packed_device_view("cpu")
    if "ptf" in phases:
        smoke.phase_ptf()
    if "parity" in phases:
        smoke.phase_sched_parity()
    if "sched" in phases:
        smoke.phase_sched(store, values, packed)
    if "rollup" in phases:
        smoke.phase_rollup(store, values, packed)
    print(f"rehearsal of {phases} at {args.tuples} tuples took "
          f"{time.perf_counter() - t0:.1f} s on the CPU")
    return 0


if __name__ == "__main__":
    sys.exit(main())
