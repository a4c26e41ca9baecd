#!/usr/bin/env python3
"""Device time of the round-extraction kernels of one checkout, the packed
``slot_extract`` and ``slot_extract_grouped`` and the slab kernels
``slot_extract_stream`` and ``slot_eval_decoded``, and of the full-scan
rows kernels ``chunk_agg`` and ``round_stats``, at ``chip_smoke.py``'s
timing shapes, so that two checkouts can be compared on one card in one
call:

    git archive PARENT | tar -x -C build/parent
    for d in build/parent . . build/parent; do
        python3 scripts/time_slot_kernels.py --root "$d"
    done

``--root`` names the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are imported; the smoke's input builders make the same inputs from the same
seeds in every checkout that has them.  Each kernel runs at W = 4 with full
budgets over 16 input sets, cycled, on a 512 MiB store, far past the L2
cache: ``slot_extract`` on C = 16 columns, S = 8 slots, with the decoded
window, and the grouped kernel at the grouped deployment's C = 4, S = 4,
G = 9, H = 128, both at B in {8, 4096}; the slab kernels on the same
windows' chunks as raw slabs (64 MiB a set) and as their decoded slabs
(``extract_parse``), with ``cache_cap`` = 128 cache rows, at B in {8, 16,
32, 64, 4096}; ``chunk_agg`` over the deployment's whole 2 GiB store
(128 chunks of 65,536 rows, C = 16, its eight plans; 20 calls) and
``round_stats`` on 16 of its gathered round windows (4, 4096, 256), 200
calls.  The 2 GiB store is built once and kept at ``--rows-store`` (under
the git-ignored ``build/``) for the next run.  Prints one JSON line: per
kernel and B the
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


def slab_inputs(cs, sets):
    """The slab kernels' view of ``slot_extract``'s input sets
    (``chip_smoke.stream_inputs``): (raw slab of chunks jw, its decoded
    slab, (idx, b_eff, plan..., m_before)) each."""
    from repro_torch.kernels.extract_parse import extract_parse_cuda

    out = []
    for inp in sets:
        slab, idx, b_eff, plan, mb = cs.stream_inputs(inp)
        w, r, rec = slab.shape
        c = rec // cs.FIELD_BYTES
        dec = extract_parse_cuda(slab.reshape(w * r, rec), c).reshape(w, r, c)
        out.append((slab, dec, (idx, b_eff, *plan, mb)))
    return out


def slab_calls(ssets, cap: int):
    """The two timed slab-kernel calls over the cycled input sets."""
    from repro_torch.kernels.slot_extract_stream import (
        slot_eval_decoded_cuda, slot_extract_stream_cuda)

    def k2(i):
        slab, _, args = ssets[i % 16]
        return slot_extract_stream_cuda(slab, *args, cache_cap=cap)

    def k3(i):
        _, dec, args = ssets[i % 16]
        return slot_eval_decoded_cuda(dec, *args, cache_cap=cap)

    return (("slot_extract_stream", k2), ("slot_eval_decoded", k3))


def rows_store(cs, path: str):
    """The deployment's store packed on the card, its chunk sizes and its
    eight plans (coeffs, lo, hi) on the card: from ``path`` when an earlier
    run left it there, else built with the checkout's ``build_store`` and
    saved."""
    if not os.path.exists(path):
        values, store = cs.build_store(cs.NUM_TUPLES, cs.NUM_CHUNKS,
                                       cs.NUM_COLS)
        packed, sizes = store.packed_device_view("cuda")
        _, plan = cs.deployment_plan(values)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez(path + ".tmp.npz", packed=packed.cpu().numpy(),
                 sizes=np.asarray(sizes),
                 **{k: t.cpu().numpy() for k, t in zip(("cf", "lo", "hi"),
                                                       plan)})
        os.replace(path + ".tmp.npz", path)
    z = np.load(path)
    return (torch.as_tensor(z["packed"], device="cuda"), z["sizes"],
            [torch.as_tensor(z[k], device="cuda") for k in ("cf", "lo", "hi")])


def rows_calls(cs, packed, sizes, plan, rng):
    """The two timed rows-kernel calls: ``chunk_agg`` over the whole store
    (20 calls) and ``round_stats`` over 16 gathered windows at B = 4096
    (200 calls)."""
    from repro_torch.kernels.chunk_agg import chunk_agg_cuda
    from repro_torch.kernels.round_stats import round_stats_cuda

    sizes_t = torch.as_tensor(sizes, dtype=torch.int32, device="cuda")
    slabs = []
    for _ in range(16):
        jw, idx, _ = cs.round_window(packed, sizes, 4096, rng)
        slabs.append(packed[jw.long()[:, None], idx.long()].contiguous())
    b_eff = torch.full((4,), 4096, dtype=torch.int32, device="cuda")

    def k6(i):
        return chunk_agg_cuda(packed, sizes_t, *plan)

    def k7(i):
        return round_stats_cuda(slabs[i % 16], b_eff, *plan)

    return (("chunk_agg N=128", k6, 20), ("round_stats B=4096", k7, 200))


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
    ap.add_argument("--rows-store", default="build/time_rows_store.npz",
                    help="where the 2 GiB store is kept between runs")
    ap.add_argument("--only-rows", action="store_true",
                    help="time chunk_agg and round_stats only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_slot_kernels: no CUDA device", file=sys.stderr)
        return 2
    cs = import_checkout(args.root)
    packed_stores = None if args.only_rows else stores(cs)
    rng = np.random.default_rng(5)
    out = {"root": args.root, "card": cs.card_line(), "kernels": {}}
    packed, sizes, plan = rows_store(cs, args.rows_store)
    for name, fn, iters in rows_calls(cs, packed, sizes, plan,
                                      np.random.default_rng(31)):
        dev, n = device_us(fn, iters)
        out["kernels"][name] = dict(device_us=dev, device_kernels_per_call=n,
                                    wall_us=wall_us(fn, iters))
    del packed
    for b in () if args.only_rows else (8, 16, 32, 64, 4096):
        sets, gsets = timing_inputs(cs, packed_stores, rng, b)
        timed = list(calls(sets, gsets)) if b in (8, 4096) else []
        timed += slab_calls(slab_inputs(cs, sets), cs.CACHE_CAP)
        for name, fn in timed:
            dev, n = device_us(fn, args.iters)
            out["kernels"][f"{name} B={b}"] = dict(
                device_us=dev, device_kernels_per_call=n,
                wall_us=wall_us(fn, args.iters))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
