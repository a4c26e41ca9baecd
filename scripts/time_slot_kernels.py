#!/usr/bin/env python3
"""Device time of the packed round-extraction kernels of one checkout,
``slot_extract`` and ``slot_extract_grouped``, at ``chip_smoke.py``'s timing
shapes, so that two checkouts can be compared on one card in one call:

    git archive PARENT | tar -x -C build/parent
    for d in build/parent . . build/parent; do
        python3 scripts/time_slot_kernels.py --root "$d"
    done

``--root`` names the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are imported; the smoke's input builders make the same inputs from the same
seeds in every checkout that has them.  Each kernel runs at W = 4 and
B in {8, 4096} with full budgets over 16 input sets, cycled (``slot_extract``
on C = 16 columns, S = 8 slots, with the decoded window; the grouped kernel
at the grouped deployment's C = 4, S = 4, G = 9, H = 128), on a 512 MiB
store, far past the L2 cache.  Prints one JSON line: per kernel and B the
device µs per call (every device activity of 200 calls, ``torch.profiler``,
so the count does not depend on the kernels' names), the device kernels per
call and the wall µs per call with the wrapper (CUDA events), beside the
card's name and power limit.  Needs a CUDA device (exit 2 without one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def device_us(fn, iters: int) -> tuple[float, float]:
    """(device µs per call, device activities per call) over ``iters``
    calls after one warm-up call, from a CUPTI trace."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in events) / iters,
            sum(e.count for e in events) / iters)


def wall_us(fn, iters: int) -> float:
    """Wall µs per call with the host work, CUDA events, after warm-up."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def timing_inputs(cs, packed_stores, rng, b: int):
    """16 input sets of each kernel at window width ``b``, full budgets, on
    the stores of :func:`stores`: (slot_extract sets, grouped sets)."""
    (packed, sizes), (gpacked, gsizes) = packed_stores
    sets = []
    for _ in range(16):
        inp = list(cs.kernel_inputs(packed, sizes, b, rng))
        inp[3] = torch.full_like(inp[3], b)
        sets.append(inp)
    gsets = []
    for _ in range(16):
        base, groups, salt = cs.grouped_case(gpacked, gsizes, b, rng,
                                             "deployment")
        base[3] = torch.minimum(
            torch.full_like(base[3], b),
            torch.as_tensor(gsizes, device="cuda")[base[1].long()]
            .to(torch.int32))
        gsets.append((base, groups, salt))
    return sets, gsets


def stores(cs):
    """The main store cut to 32 chunks (512 MiB, far past L2) and the
    grouped deployment's, packed on the card, each with its chunk sizes."""
    _, store = cs.build_store(65536 * 32, 32, cs.NUM_COLS)
    packed, sizes = store.packed_device_view("cuda")
    _, gstore = cs.build_wiki_store(cs.GROUP_TUPLES, cs.GROUP_CHUNKS,
                                    cs.GROUP_LANGS)
    gpacked, gsizes = gstore.packed_device_view("cuda")
    return ((packed, np.asarray(sizes)), (gpacked, np.asarray(gsizes)))


def calls(sets, gsets):
    """The two timed calls over the cycled input sets."""
    from repro_torch.kernels.slot_extract import slot_extract_cuda
    from repro_torch.kernels.slot_extract_grouped import (
        slot_extract_grouped_cuda)

    def k1(i):
        return slot_extract_cuda(*sets[i % 16], return_cols=True)

    def k4(i):
        base, groups, salt = gsets[i % 16]
        return slot_extract_grouped_cuda(*base, *groups, salt, 128)

    return (("slot_extract", k1), ("slot_extract_grouped", k4))


def import_checkout(root: str):
    """chip_smoke.py and repro_torch of the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke
    return chip_smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="checkout to time")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_slot_kernels: no CUDA device", file=sys.stderr)
        return 2
    cs = import_checkout(args.root)
    packed_stores = stores(cs)
    rng = np.random.default_rng(5)
    out = {"root": args.root, "card": cs.card_line(), "kernels": {}}
    for b in (8, 4096):
        for name, fn in calls(*timing_inputs(cs, packed_stores, rng, b)):
            dev, n = device_us(fn, args.iters)
            out["kernels"][f"{name} B={b}"] = dict(
                device_us=dev, device_kernels_per_call=n,
                wall_us=wall_us(fn, args.iters))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
