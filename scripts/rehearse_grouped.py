#!/usr/bin/env python3
"""Rehearse chip_smoke.py's grouped deployment on the CPU, through either
package, at a chosen tuple count.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/rehearse_grouped.py \\
        --package repro_torch --tuples 262144

The workload is ``chip_smoke.py``'s grouped deployment
(``benchmarks/bench_workload.py``'s full grouped lane): ``make_wiki_like``
with 40 languages in 128 uneven chunks, eight grouped SUM queries (rng
seed 3), ``EngineConfig(num_workers=4, seed=7, max_groups=8)``,
``ServerOptions(max_slots=4, synopsis_budget_tuples=0)``.  It prints the
round count, the per-round budget rungs, and per query its rounds, tuples
seen, top-5 recall against the exact per-language totals and its worst
top-5 cell's distance from its exact total in units of ε — what sizes the
deployment (its round count) and what its 3·ε check will see.  Either
package runs on the CPU: ``repro`` (the JAX reference, ``extract_backend``
"ref") or ``repro_torch`` (the port, its kernels' plain versions).
"""

from __future__ import annotations

import argparse
import importlib
import time

import numpy as np

LANGS, CHUNKS, QUERIES, TOP_K = 40, 128, 8, 5


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    default="repro_torch")
    ap.add_argument("--tuples", type=int, default=262_144)
    args = ap.parse_args()
    pkg = args.package
    q = importlib.import_module(f"{pkg}.core.queries")
    eng = importlib.import_module(f"{pkg}.core.engine")
    gen = importlib.import_module(f"{pkg}.data.generator")
    srv_mod = importlib.import_module(f"{pkg}.serve.ola_server")

    values, _ = gen.make_wiki_like(args.tuples, num_languages=LANGS, seed=0)
    store = gen.store_dataset(values, CHUNKS, "ascii", uneven=True, seed=0)
    rng = np.random.default_rng(3)
    queries = []
    for i in range(QUERIES):
        col = int(rng.choice([1, 2]))
        eps = float(rng.uniform(0.05, 0.10))
        coeffs = tuple(1.0 if k == col else 0.0 for k in range(4))
        queries.append(q.Query(agg="sum", expr=q.Linear(coeffs), epsilon=eps,
                               name=f"g{i}-c{col}", group_by=q.GroupBy(
                                   col=0, max_groups=8, top_k=TOP_K)))
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    server = srv_mod.OLAWorkloadServer(
        store, eng.EngineConfig(num_workers=4, seed=7, max_groups=8),
        options=srv_mod.ServerOptions(max_slots=4, synopsis_budget_tuples=0),
        **kw)
    for i, query in enumerate(queries):
        server.submit(query, arrival_t=1e-4 * i)
    rungs = []
    t0 = time.perf_counter()
    results = server.run(on_round=lambda s: rungs.append(
        s.engine.budget_ladder(float(s.state.budget))))
    wall = time.perf_counter() - t0
    print(f"{pkg}: {args.tuples} tuples, rounds {server.rounds}, tuples "
          f"scanned {server.tuples_scanned}, top-up passes "
          f"{server.topup_passes}, truncated {server.truncated}, host wall "
          f"{wall:.1f} s; rounds per rung "
          f"{ {b: rungs.count(b) for b in sorted(set(rungs))} }")
    for r in results:
        query = queries[r.qid]
        col = next(k for k, c in enumerate(query.expr.coeffs) if c)
        tot = np.bincount(values[:, 0].astype(np.int64),
                          weights=values[:, col], minlength=LANGS)
        top = set(np.argsort(-tot, kind="stable")[:TOP_K].astype(float))
        tracked = [g for g in (r.groups or []) if not g.is_other]
        recall = len(top & {g.value for g in tracked}) / TOP_K
        cells = sorted(tracked, key=lambda g: -abs(g.estimate))[:TOP_K]
        worst = max((abs(g.estimate - tot[int(g.value)]) / tot[int(g.value)]
                     for g in cells), default=float("inf")) / query.epsilon
        print(f"  {r.name:>6} eps {query.epsilon:.4f} rounds "
              f"{r.rounds_resident:6d} seen {r.tuples_seen:7d} recall "
              f"{recall:.2f} worst top-{TOP_K} cell {worst:8.3f}·eps")


if __name__ == "__main__":
    main()
