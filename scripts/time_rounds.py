#!/usr/bin/env python3
"""Wall time per server round of one checkout on the three single-device
deployments of ``chip_smoke.py``, so that two checkouts can be compared on
one card in one call:

    git archive PARENT | tar -x -C build/parent
    for d in build/parent . . build/parent; do
        python3 scripts/time_rounds.py --root "$d"
    done

``--root`` names the checkout whose ``src/repro_torch`` and ``chip_smoke.py``
are imported; the smoke's builders make the same stores, queries and
arrivals from the same seeds in every checkout that has them, so both
checkouts serve the same rounds.  The cells:

* ``packed``: the 2 GiB deployment (8,388,608 tuples, 128 chunks, its eight
  Poisson queries, ``ENGINE``/``OPTIONS``), packed on the card;
* ``stream``: the same store and queries with ``residency="stream"`` and
  the 1 GiB decoded cache (the store held in host memory, not on disk);
* ``grouped``: the grouped deployment (``GROUP_TUPLES`` wiki-like tuples,
  or ``--grouped-tuples``, and ``--grouped-queries`` of the lane's grouped
  queries).

Each serves ``--warmup`` rounds, then ``--rounds`` timed rounds (the same
rounds in every checkout: the engines are deterministic), and reports the
wall ms per round between two device synchronisations, with the grouped
discovery fold's host ms per round beside it.  Prints one JSON line with
the card's name and power limit.  Needs a CUDA device (exit 2 without
one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def import_checkout(root: str):
    """chip_smoke.py and repro_torch of the checkout at ``root``."""
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke
    return chip_smoke


def timed_rounds(server, warmup: int, rounds: int) -> dict:
    """Serve ``warmup`` rounds, then time ``rounds`` more."""
    fold = {"s": 0.0}
    fold_fn = getattr(server, "_fold_group_discovery", None)
    if fold_fn is not None:
        def timed_fold(rep):
            t = time.perf_counter()
            fold_fn(rep)
            fold["s"] += time.perf_counter() - t

        server._fold_group_discovery = timed_fold
    server.run(max_rounds=warmup)
    torch.cuda.synchronize()
    first, fold["s"] = server.rounds, 0.0
    t0 = time.perf_counter()
    server.run(max_rounds=warmup + rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = server.rounds - first
    server.close()
    return dict(rounds=n, first_round=first, ms_per_round=1e3 * wall / n,
                fold_ms_per_round=1e3 * fold["s"] / n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="checkout to time")
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=1500)
    ap.add_argument("--grouped-tuples", type=int, default=None,
                    help="the grouped cell's tuples (default GROUP_TUPLES)")
    ap.add_argument("--grouped-queries", type=int, default=8)
    ap.add_argument("--cells", default="packed,stream,grouped")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_rounds: no CUDA device", file=sys.stderr)
        return 2
    cs = import_checkout(args.root)
    cs._build.build_all()
    cells = args.cells.split(",")
    out = {"root": args.root, "card": cs.card_line(), "cells": {}}
    if "packed" in cells or "stream" in cells:
        values, store = cs.build_store(cs.NUM_TUPLES, cs.NUM_CHUNKS,
                                       cs.NUM_COLS)
        queries = cs.deployment_queries(values)
        arrivals = [at for _, at in cs.poisson_workload(
            queries, cs.ARRIVALS_PER_MODEL_S, seed=cs.ARRIVAL_SEED)]
        configs = {
            "packed": cs.EngineConfig(**cs.ENGINE),
            "stream": cs.EngineConfig(
                residency="stream",
                decoded_cache_bytes=cs.DECODED_CACHE_BYTES, **cs.ENGINE)}
        for name in ("packed", "stream"):
            if name not in cells:
                continue
            server = cs.OLAWorkloadServer(
                store, configs[name], options=cs.ServerOptions(**cs.OPTIONS),
                device="cuda")
            for q, at in zip(queries, arrivals):
                server.submit(q, arrival_t=at)
            out["cells"][name] = timed_rounds(server, args.warmup,
                                              args.rounds)
        del store, values
    if "grouped" in cells:
        tuples = args.grouped_tuples or cs.GROUP_TUPLES
        _, gstore = cs.build_wiki_store(tuples, cs.GROUP_CHUNKS,
                                        cs.GROUP_LANGS)
        server = cs.OLAWorkloadServer(
            gstore, cs.EngineConfig(**cs.GROUP_ENGINE),
            options=cs.ServerOptions(**cs.GROUP_OPTIONS), device="cuda")
        for i, q in enumerate(cs.grouped_queries(args.grouped_queries)):
            server.submit(q, arrival_t=1e-4 * i)
        out["cells"]["grouped"] = dict(
            timed_rounds(server, args.warmup, args.rounds),
            tuples=tuples, queries=args.grouped_queries)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
