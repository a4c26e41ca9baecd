#!/usr/bin/env python3
"""Where the device time of ``slot_extract`` and ``slot_extract_grouped``
goes: each kernel built again with one phase cut off, timed beside the
whole kernel on the inputs of ``scripts/time_slot_kernels.py``.

    python3 scripts/tile_phase_times.py

A cut is an early return or a loop run zero times, patched into a copy of
``src/repro_torch/csrc`` under ``build/tile_phases/<cut>/`` and built with
the package's nvcc flags; the difference between two cuts is the time of
what lies between them.  A cut kernel's outputs are wrong: it is only
timed.  The patches match lines of ``csrc/slot_tile.cuh`` and fail loudly
when that file no longer has them.  Prints a table and, last, one JSON line
of device µs per call (every device activity of 200 calls,
``torch.profiler``) by cut, kernel and B, beside the card's name and power
limit.  Needs a CUDA device and nvcc (exit 2 without a device).
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

# cut -> [(text in slot_tile.cuh, its replacement)]
CUTS = {
    "whole kernel": [],
    "launch only": [(
        "  const int C = CT > 0 ? CT : a.C;\n",
        "  return;\n  const int C = CT > 0 ? CT : a.C;\n")],
    "+ indices": [(
        "  __syncthreads();\n\n  // 2. every field",
        "  __syncthreads();\n  return;\n\n  // 2. every field")],
    "+ rows, plan, parse": [(
        "  __syncthreads();  // rows parsed, plan in shared memory\n",
        "  __syncthreads();  // rows parsed, plan in shared memory\n"
        "  return;\n")],
    "no slot rounds": [(
        "  for (int s0 = 0; s0 < S; s0 += SG) {",
        "  for (int s0 = 0; s0 < 0; s0 += SG) {")],
    "no cells": [(
        "      for (int c = sg; c < S * G; c += P) {",
        "      for (int c = sg; c < 0; c += P) {")],
    "no tallies": [(
        "    if constexpr (kGrouped) {\n      // tallies",
        "    if constexpr (false) {\n      // tallies")],
    "tallies staged, not summed": [(
        "      for (int i = tid; i < SG * H; i += T) {",
        "      for (int i = tid; i < 0; i += T) {")],
    "tiles only, no fold": [(
        "  // more than one tile: the worker's last block folds",
        "  if (gridDim.x > 1) return;\n"
        "  // more than one tile: the worker's last block folds")],
}
KERNELS = ("slot_extract", "slot_extract_grouped")


def build_cuts() -> dict:
    """Every cut's two libraries, built at once: {cut: {name: path}}."""
    from repro_torch.kernels import _build

    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    text = open(os.path.join(csrc, "slot_tile.cuh")).read()
    procs, libs = [], {}
    for i, (cut, patches) in enumerate(CUTS.items()):
        d = os.path.join(ROOT, "build", "tile_phases", str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        patched = text
        for old, new in patches:
            if old not in patched:
                raise RuntimeError(f"cut {cut!r}: slot_tile.cuh no longer "
                                   f"has {old!r}")
            patched = patched.replace(old, new, 1)
        with open(os.path.join(d, "slot_tile.cuh"), "w") as f:
            f.write(patched)
        libs[cut] = {}
        for name in KERNELS:
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
        print("tile_phase_times: no CUDA device", file=sys.stderr)
        return 2
    cs = tsk.import_checkout(ROOT)
    from repro_torch.kernels import _build
    from repro_torch.kernels import slot_extract as k1mod

    libs = build_cuts()
    packed_stores = tsk.stores(cs)
    rng = np.random.default_rng(5)
    inputs = {b: tsk.timing_inputs(cs, packed_stores, rng, b)
              for b in (8, 4096)}
    out = {"card": cs.card_line(), "device_us": {}}
    for cut, paths in libs.items():
        loaded = {name: ctypes.CDLL(path) for name, path in paths.items()}
        _build.load = loaded.__getitem__
        k1mod._COUNTERS.clear()        # fresh, zeroed tile counters
        for b, sets in inputs.items():
            for name, fn in tsk.calls(*sets):
                out["device_us"][f"{cut} | {name} B={b}"] = tsk.device_us(
                    fn, 200)[0]
    print(out["card"])
    cols = [f"{n} B={b}" for b in (8, 4096) for n in KERNELS]
    print(f"{'cut':>28} " + " ".join(f"{c:>27}" for c in cols))
    for cut in CUTS:
        print(f"{cut:>28} " + " ".join(
            f"{out['device_us'][f'{cut} | {c}']:27.2f}" for c in cols))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
