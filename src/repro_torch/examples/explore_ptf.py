"""The paper's motivating workflow (Section 1): PTF candidate-batch
verification as a sequence of HAVING queries with early-out.

    python -m repro_torch.examples.explore_ptf [--device cpu]

A clumped "telescope night" table is verified by three aggregate checks;
the controller stops each query as soon as its confidence interval decides
the HAVING predicate, and aborts the whole sequence on the first failure —
no load, no full scan, no wasted work on an uninteresting batch.
"""

import argparse

from repro_torch.core import (TRUE, Column, EngineConfig,
                              EstimationController, Having, Query, Range)
from repro_torch.data.generator import make_ptf_like, store_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    candidates = make_ptf_like(num_tuples=32768, num_chunks_hint=64, seed=1)
    store = store_dataset(candidates, num_chunks=64, fmt="binary",
                          name="ptf_night")
    # ground truth for context
    print(f"batch: {store.num_tuples} candidates in {store.num_chunks} "
          f"binary (FITS-like) chunks")
    print(f"true mean mag {candidates[:, 3].mean():.3f}, "
          f"true mean err {candidates[:, 4].mean():.4f}\n")

    verification = [
        # mean photometric error must be small
        Query(agg="avg", expr=Column(4), pred=TRUE,
              having=Having("<", 0.05), epsilon=0.05,
              name="avg_mag_err<0.05"),
        # enough bright detections (mag < 17)
        Query(agg="count", pred=Range(3, 0.0, 17.0),
              having=Having(">", 500.0), epsilon=0.05, name="bright>500"),
        # mean magnitude sane
        Query(agg="avg", expr=Column(3), pred=TRUE,
              having=Having("<", 22.0), epsilon=0.05, name="avg_mag<22"),
    ]

    # the fused kernel parses ASCII records; "auto" takes the decode +
    # evaluator path for this binary batch
    ctrl = EstimationController(
        store, EngineConfig(num_workers=4, strategy="resource_aware", seed=3,
                            extract_backend="auto"),
        synopsis_budget_tuples=4096, device=args.device)
    results = ctrl.run_verification(verification)

    passed = len(results) == len(verification) and all(
        int(r.decisions[0]) != 0 for r in results)
    for q, r in zip(verification, results):
        verdict = {1: "PASS", 0: "FAIL", -1: "exact"}[int(r.decisions[0])]
        print(f"{q.name:20s} -> {verdict:5s} est={r.final_estimate[0]:12.4g} "
              f"tuples={100 * r.tuples_ratio:5.1f}% "
              f"t_model={r.t_model_total * 1e3:7.3f}ms "
              f"synopsis={r.from_synopsis}")
    print(f"\nbatch verdict: "
          f"{'ADMIT -> in-depth analysis' if passed else 'REJECT'}")
    return {"results": results, "passed": passed}


if __name__ == "__main__":
    main()
