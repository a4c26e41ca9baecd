"""Workload serving demo: a stream of OLA queries sharing one scan.

    python -m repro_torch.examples.serve_ola_workload [--device cpu]

Generates a zipfian raw table, then fires a Poisson stream of mixed
SUM/COUNT/AVG queries (different selectivities, ε targets, and HAVING
clauses) at the :class:`OLAWorkloadServer`.  Queries join the shared scan
mid-flight (seeded from the bi-level synopsis), leave as soon as their
target is met, and the server reports per-query latency plus how many raw
tuples the whole workload cost — compare with running each query as its
own scan.
"""

import argparse

import numpy as np

from repro_torch.core.engine import EngineConfig
from repro_torch.core.queries import Having, Linear, Query, Range
from repro_torch.data.generator import make_synthetic_zipf, store_dataset
from repro_torch.serve.ola_server import (OLAWorkloadServer, ServerOptions,
                                          select_plan)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    values = make_synthetic_zipf(num_tuples=16384, num_cols=8, seed=0)
    store = store_dataset(values, num_chunks=64, fmt="ascii")
    coef = tuple(1.0 / (k + 1) for k in range(8))
    x = values @ np.asarray(coef)
    exact_sum = float(x.sum())

    cfg = EngineConfig(num_workers=4, seed=7)
    server = OLAWorkloadServer(
        store, cfg, options=ServerOptions(max_slots=4,
                                          synopsis_budget_tuples=4096),
        device=args.device)

    workload = [
        (Query(agg="sum", expr=Linear(coef), epsilon=0.05,
               name="sum-all"), 0.0),
        (Query(agg="count", pred=Range(0, 0.0, 4e7), epsilon=0.08,
               name="count-sel"), 0.0005),
        (Query(agg="sum", expr=Linear(coef), pred=Range(0, 0.0, 6e7),
               having=Having("<", exact_sum), epsilon=0.05,
               name="having-verify"), 0.001),
        (Query(agg="avg", expr=Linear(coef), epsilon=0.05,
               name="avg-all"), 0.0015),
        (Query(agg="sum", expr=Linear(coef), epsilon=0.03,
               name="sum-tight"), 0.002),
    ]
    for q, at in workload:
        plan = select_plan(store, cfg, q)
        print(f"submit {q.name:14s} arrival={at:.4f}s plan={plan}")
        server.submit(q, arrival_t=at)

    results = server.run()

    print(f"\n{'query':>14} {'plan':>14} {'estimate':>12} {'err%':>6} "
          f"{'dec':>3} {'latency(s)':>10} {'seeded':>6} {'seen':>6}")
    for r in results:
        print(f"{r.name:>14} {r.plan:>14} {r.estimate:12.4g} "
              f"{100 * r.err:6.2f} {r.decision:3d} {r.latency:10.5f} "
              f"{r.seeded_tuples:6d} {r.tuples_seen:6d}")
    print(f"\nshared scan extracted {server.tuples_scanned} of "
          f"{store.num_tuples} tuples for {len(results)} queries "
          f"({server.rounds} rounds, {server.topup_passes} top-up passes); "
          f"exact SUM = {exact_sum:.6g}")
    server.close()
    return {"values": values, "queries": [q for q, _ in workload],
            "results": results}


if __name__ == "__main__":
    main()
