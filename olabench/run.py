"""The benchmark of ``repro_torch``: one run of one cell.

    python olabench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control]

Run from the root of a checkout on a machine with the cell's CUDA cards.
The last line of standard output is the run's JSON result; the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error and the result's last key.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.  ``--control``
answers at the configuration's control confidence (a broken guarantee the
check has to catch) and is never part of the benchmark's own runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that must not be loaded in a run: the JAX stack and the
#: reference package the port was made from (compared as whole names: the
#: port's own name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    # every build of the program's kernels stays inside this checkout, at
    # one fixed place, so only a checkout's first run compiles
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(HERE, ".cache",
                                                       "kernels")
    sys.path[:0] = [HERE, os.path.join(ROOT, "src")]
    import torch

    # the host paces every round: one thread for torch's CPU ops keeps
    # the host's work steady from run to run
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)

    from harness import cell as cell_run
    from harness import report, spec

    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = cell_run.run(cell, args.seed % 2 ** 63, args.seconds,
                       bool(args.trace), "cuda:0", T_START,
                       control=args.control)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    out = report.result(cell, res, bool(args.trace))
    for name, n in out["checks"].items():
        print(f"check {name} {n['value']} limit {n['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
