#!/usr/bin/env python3
"""Where the device time of the rows kernels ``chunk_agg`` and
``round_stats`` goes, and what reading the plan from the constant bank
would save: each kernel built again with one phase cut off, or with the
plan read another way, and timed beside the whole kernel on the inputs of
``scripts/time_slot_kernels.py`` (``chunk_agg`` over the deployment's
2 GiB store, 20 calls; ``round_stats`` on 16 gathered (4, 4096, 256)
windows, 200 calls; both with the deployment's eight plans at C = 16).

    python3 scripts/rows_phase_times.py

A cut is an early return or a loop run zero times, patched into a copy of
``src/repro_torch/csrc`` under ``build/rows_phases/<n>/`` and built with
the package's nvcc flags; the difference between two cuts is the time of
what lies between them.  A cut kernel's outputs are wrong: it is only
timed.  The variant "plan in the constant bank" reads each plan value as
an operand of the compare or multiply-add (a ``__constant__`` array filled
once by the script, as a plan passed by value in the kernel's parameters
would be read) instead of with 16-byte broadcast loads from shared memory;
the variant "last-block flag in static shared memory" declares the fold's
flag ``__shared__`` (16 bytes of static shared memory) instead of reusing
the warps' sums.
Every cut runs the whole kernel's grid.  The patches match lines of
``csrc/rows_tile.cuh`` and fail loudly when that file no longer has them.
Prints a table and, last, one JSON line of device µs per call (every
device activity of the calls, ``torch.profiler``) by cut and kernel,
beside the card's name and power limit.  Needs a CUDA device and nvcc
(exit 2 without a device).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE]
import time_slot_kernels as tsk  # noqa: E402

KERNELS = ("chunk_agg", "round_stats")
NO_EVAL = ("      if (tid < nr) {\n        const float* row",
           "      if (false) {\n        const float* row")
NO_PARSE = [("      if (kFixed && nr == TR) {", "      if (false) {"),
            ("        for (int q = tid; q < nr * C; q += kThreads) {",
             "        for (int q = tid; q < 0; q += kThreads) {")]
CONST_PLAN = [
    ("constexpr int kMaxSmem = 227 * 1024;    // shared memory a block may have\n",
     "constexpr int kMaxSmem = 227 * 1024;    // shared memory a block may have\n"
     "__constant__ float kPlanConst[3 * kPlans * 16];\n"),
    ("""              const float4* pc = reinterpret_cast<const float4*>(plan + q * CT);
              const float4* pl = reinterpret_cast<const float4*>(plan + (kPlans + q) * CT);
              const float4* ph = reinterpret_cast<const float4*>(plan + (2 * kPlans + q) * CT);
#pragma unroll
              for (int c = 0; c < CT; c += 4) {
                const float4 x = pc[c / 4], y = pl[c / 4], z = ph[c / 4];
                cf[c] = x.x, cf[c + 1] = x.y, cf[c + 2] = x.z, cf[c + 3] = x.w;
                lo[c] = y.x, lo[c + 1] = y.y, lo[c + 2] = y.z, lo[c + 3] = y.w;
                hi[c] = z.x, hi[c + 1] = z.y, hi[c + 2] = z.z, hi[c + 3] = z.w;
              }""",
     """#pragma unroll
              for (int c = 0; c < CT; ++c) {
                cf[c] = kPlanConst[q * CT + c];
                lo[c] = kPlanConst[(kPlans + q) * CT + c];
                hi[c] = kPlanConst[(2 * kPlans + q) * CT + c];
              }""")]
# cut -> [(text in rows_tile.cuh, its replacement)]
CUTS = {
    "whole kernel": [],
    "launch only": [("  const int C = kFixed ? CT : a.C;\n",
                     "  return;\n  const int C = kFixed ? CT : a.C;\n")],
    "rows copied, no parse, no evaluation": [NO_EVAL, *NO_PARSE],
    "no evaluation": [NO_EVAL],
    "no fold": [("  if (P == 1) return;\n\n", "  return;\n\n")],
    "plan in the constant bank": CONST_PLAN,
    "last-block flag in static shared memory": [(
        "  int& last_block = *reinterpret_cast<int*>(red);\n",
        "  __shared__ int last_block;\n")],
}
SET_PLAN = """
extern "C" int {name}_set_plan(const float* host, int n) {{
  return (int)cudaMemcpyToSymbol(slot::rows::kPlanConst, host, n * sizeof(float));
}}
"""


def build_cuts() -> dict:
    """Every cut's two libraries, built at once: {cut: {name: path}}."""
    from repro_torch.kernels import _build

    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    text = open(os.path.join(csrc, "rows_tile.cuh")).read()
    procs, libs = [], {}
    for i, (cut, patches) in enumerate(CUTS.items()):
        d = os.path.join(ROOT, "build", "rows_phases", str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        patched = text
        for old, new in patches:
            if old not in patched:
                raise RuntimeError(f"cut {cut!r}: rows_tile.cuh no longer "
                                   f"has {old!r}")
            patched = patched.replace(old, new, 1)
        with open(os.path.join(d, "rows_tile.cuh"), "w") as f:
            f.write(patched)
        libs[cut] = {}
        for name in KERNELS:
            if patches is CONST_PLAN:
                with open(os.path.join(d, f"{name}.cu"), "a") as f:
                    f.write(SET_PLAN.format(name=name))
            lib = os.path.join(d, f"lib{name}.so")
            libs[cut][name] = lib
            procs.append((cut, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(d, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for cut, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"cut {cut!r} does not build:\n{log}")
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("rows_phase_times: no CUDA device", file=sys.stderr)
        return 2
    cs = tsk.import_checkout(ROOT)
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunk_agg as ca
    from repro_torch.kernels import slot_extract as k1mod

    libs = build_cuts()
    packed, sizes, plan = tsk.rows_store(
        cs, os.path.join(ROOT, "build", "time_rows_store.npz"))
    calls = tsk.rows_calls(cs, packed, sizes, plan,
                           np.random.default_rng(31))
    # every cut on the whole kernel's grid (a cut's registers may differ)
    c, q = packed.shape[2] // cs.FIELD_BYTES, plan[0].shape[0]
    slots = {name: ca._slots(ca._lib(name), name, c, q, packed.device)
             for name in KERNELS}
    ca._slots = lambda lib, name, *rest: slots[name]
    host_plan = np.ascontiguousarray(np.concatenate(
        [t.cpu().numpy().reshape(-1) for t in plan]), np.float32)
    out = {"card": cs.card_line(), "device_us": {}}
    for cut, paths in libs.items():
        loaded = {name: ctypes.CDLL(path) for name, path in paths.items()}
        _build.load = loaded.__getitem__
        k1mod._COUNTERS.clear()        # fresh, zeroed tile counters
        for name, lib in loaded.items():
            if CUTS[cut] is CONST_PLAN:
                set_plan = getattr(lib, f"{name}_set_plan")
                set_plan.argtypes = [ctypes.c_void_p, ctypes.c_int]
                set_plan.restype = ctypes.c_int
                err = set_plan(host_plan.ctypes.data, host_plan.size)
                if err:
                    raise RuntimeError(f"{name}_set_plan: CUDA error {err}")
        for label, fn, iters in calls:
            out["device_us"][f"{cut} | {label}"] = tsk.device_us(fn,
                                                                 iters)[0]
    print(out["card"])
    cols = [label for label, _, _ in calls]
    print(f"{'cut':>38} " + " ".join(f"{c:>20}" for c in cols))
    for cut in CUTS:
        print(f"{cut:>38} " + " ".join(
            f"{out['device_us'][f'{cut} | {c}']:20.2f}" for c in cols))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
