"""Quickstart: online aggregation over a raw dataset.

    python -m repro_torch.examples.quickstart [--device cpu]

Generates a zipfian raw table (ASCII fixed-width — the CPU-bound EXTRACT
case), runs one SUM query with the resource-aware bi-level engine, and
prints the estimate converging against the exact answer.
"""

import argparse

import numpy as np

from repro_torch.core import (EngineConfig, EstimationController, Linear,
                              Query, Range)
from repro_torch.data.generator import make_synthetic_zipf, store_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    # --- a "raw file": 32k tuples x 16 columns, 64 chunks, ASCII format ----
    values = make_synthetic_zipf(num_tuples=32768, num_cols=16, seed=0)
    store = store_dataset(values, num_chunks=64, fmt="ascii")

    # --- the query: SELECT SUM(Σ c_k·A_k) WHERE A_0 < 5e7, ε = 3% ----------
    coef = tuple(1.0 / (k + 1) for k in range(16))
    query = Query(agg="sum", expr=Linear(coef), pred=Range(0, 0.0, 5e7),
                  epsilon=0.03)
    sel = (values[:, 0] >= 0) & (values[:, 0] < 5e7)
    exact = float((values @ np.asarray(coef)) @ sel)

    # --- run with δ-interval progress reports -------------------------------
    ctrl = EstimationController(
        store, EngineConfig(num_workers=4, strategy="resource_aware", seed=7),
        delta_model_s=0.002, device=args.device)
    result = ctrl.run_query([query])

    print(f"{'t_model(s)':>10} {'estimate':>14} {'error%':>8} {'n':>4} "
          f"{'m':>7}")
    for r in result.reports:
        print(f"{r.t_model:10.4f} {r.estimate[0]:14.4g} "
              f"{100 * r.err[0]:8.2f} {r.n_chunks:4d} {r.m_tuples:7d}")
    print(f"\nexact answer     : {exact:.6g}")
    print(f"final estimate   : {result.final_estimate[0]:.6g} "
          f"({100 * abs(result.final_estimate[0] - exact) / abs(exact):.2f}"
          "% off)")
    print(f"tuples extracted : {100 * result.tuples_ratio:.1f}% of the table")
    print(f"chunks read      : {100 * result.chunks_ratio:.1f}% of the file")
    return {"query": query, "result": result, "exact": exact}


if __name__ == "__main__":
    main()
