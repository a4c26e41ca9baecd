"""Observability demo: trace a served workload, explain every answer.

    python -m repro_torch.examples.trace_workload [--device cpu] [--out PATH]

Runs a small OLA workload with the span tracer and metrics registry
attached, then:

* saves the query-lifecycle trace as chrome-trace JSON (``--out``, default
  ``ola_trace.json``; open it at https://ui.perfetto.dev or in
  ``chrome://tracing``): one ``round`` span per server round, with
  ``claims``/``kernel``/``merge``/``estimate`` children;
* prints each query's explain record — the admission decision with its
  Eq. (4) cost terms, the tier that answered, and the per-round
  ``(m, estimate, ci_halfwidth)`` convergence trajectory;
* dumps the metrics registry in Prometheus text exposition format.
"""

import argparse
import json

from repro_torch.core.engine import EngineConfig
from repro_torch.core.queries import Linear, Query, Range
from repro_torch.data.generator import make_synthetic_zipf, store_dataset
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanTracer, validate_chrome_trace
from repro_torch.serve.ola_server import OLAWorkloadServer, ServerOptions


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default="ola_trace.json",
                    help="where the chrome-trace JSON is written")
    args = ap.parse_args(argv)

    values = make_synthetic_zipf(num_tuples=8192, num_cols=8, seed=0)
    store = store_dataset(values, num_chunks=32, fmt="ascii")
    coef = tuple(1.0 / (k + 1) for k in range(8))

    tracer = SpanTracer()
    metrics = MetricsRegistry()
    cfg = EngineConfig(num_workers=4, seed=7)
    server = OLAWorkloadServer(
        store, cfg, options=ServerOptions(
            max_slots=4, synopsis_budget_tuples=2048, tracer=tracer,
            metrics=metrics), device=args.device)

    workload = [
        (Query(agg="sum", expr=Linear(coef), epsilon=0.05,
               name="sum-all"), 0.0),
        (Query(agg="count", pred=Range(0, 0.0, 4e7), epsilon=0.08,
               name="count-sel"), 0.0005),
        (Query(agg="avg", expr=Linear(coef), epsilon=0.05,
               name="avg-all"), 0.001),
        (Query(agg="sum", expr=Linear(coef), pred=Range(0, 0.0, 6e7),
               epsilon=0.03, name="sum-tight"), 0.0015),
    ]
    for q, at in workload:
        server.submit(q, arrival_t=at)
    results = server.run()

    # --- chrome-trace export -------------------------------------------
    doc = tracer.to_chrome_trace()
    problems = validate_chrome_trace(doc)
    if problems:
        raise RuntimeError(f"invalid chrome trace: {problems}")
    tracer.save(args.out)
    n_spans = sum(e["ph"] == "X" for e in doc["traceEvents"])
    print(f"wrote {args.out}: {n_spans} spans "
          f"({len(doc['traceEvents'])} events) — open at ui.perfetto.dev")

    # --- per-query explain records -------------------------------------
    for r in results:
        ex = r.explain
        print(f"\n=== {r.name} -> {r.estimate:.6g} "
              f"(±{r.halfwidth:.3g}, {r.sched_outcome})")
        print(f"  admission: {ex.admission_reason} | plan={ex.plan} | "
              f"Eq.(4) T_io={ex.cost_t_io_s:.4g}s "
              f"T_cpu={ex.cost_t_cpu_s:.4g}s")
        print(f"  tier     : {ex.tier} — {ex.tier_reason}")
        traj = ex.trajectory
        for s in traj[:3]:
            print(f"  round {s.round:3d}: m={s.m:6d} est={s.est:.6g} "
                  f"ci_halfwidth={s.ci_halfwidth:.4g} b_eff={s.b_eff}")
        if len(traj) > 3:
            s = traj[-1]
            print(f"  ... round {s.round:3d}: m={s.m:6d} est={s.est:.6g} "
                  f"ci_halfwidth={s.ci_halfwidth:.4g}")
        # the full record is JSON-able for dashboards / API responses
        json.dumps(ex.to_dict())

    # --- metrics registry ----------------------------------------------
    print("\n--- metrics (Prometheus text exposition) ---")
    print(server.metrics.to_prometheus().rstrip())
    server.close()
    return {"results": results, "trace": doc}


if __name__ == "__main__":
    main()
