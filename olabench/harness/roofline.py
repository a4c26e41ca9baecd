"""Peaks of the chip and the least time of a round kernel's work.

The bounds copy ``chip_smoke.py::kernel_bound_ms`` (the packed kernel)
and ``slab_bound_ms`` (the slab kernels): the bytes a call must move, each
input read once and each output written once, over the HBM rate, against
its arithmetic over the float32 rate; the larger of the two.
"""

from __future__ import annotations

#: one NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit (NVIDIA's data sheet,
#: dense rates): HBM bytes/s and float32 operations/s outside the tensor
#: cores, which the parse and the slot arithmetic run on
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_ops_per_s": 67e12},
}
FIELD_BYTES = 16


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}: add its data sheet's rates")
    return PEAKS[kind]


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    p = peaks(kind)
    return max(nbytes / p["hbm_bytes_per_s"], ops / p["f32_ops_per_s"])


def packed_round(w: int, b: int, c: int, s: int, return_cols: bool):
    """(bytes, ops) of one packed round kernel call: the window's rows,
    indices, budgets, the plan and the (W, S, 4) stats; the decoded window
    when the synopsis cache takes it."""
    nbytes = (w * b * c * FIELD_BYTES + w * b * 4 + 2 * w * 4
              + 3 * s * c * 4 + 3 * s * 4 + w * s * 4 * 4
              + (w * b * c * 4 if return_cols else 0))
    # per row: 14 digit multiply-adds (2 ops) + 3 ops a field; per slot:
    # 2C compares, C multiply-adds, 8 ops of masking and sums
    ops = w * b * (c * (14 * 2 + 3) + s * (2 * c + 2 * c + 8))
    return nbytes, ops


def slab_round(w: int, b: int, c: int, s: int, cap: int, decoded: bool):
    """(bytes, ops) of one slab kernel call: window rows (raw records or C
    decoded floats), indices, budgets, scan positions and plan read once,
    stats and the (W, cap, C) cache rows written once."""
    row = c * 4 if decoded else c * FIELD_BYTES
    nbytes = (w * b * row + w * b * 4 + 2 * w * 4 + 3 * s * c * 4
              + 3 * s * 4 + w * s * 4 * 4 + w * cap * c * 4)
    ops = w * b * ((0 if decoded else c * (14 * 2 + 3))
                   + s * (2 * c + 2 * c + 8))
    return nbytes, ops


def round_bound_s(b: int, mode: str, shape: dict, kind: str) -> float:
    """Least seconds of one round's kernel work.  ``mode`` is the program's
    round variant: under streaming "none" (raw slab), "all" (decoded slab)
    or "mixed", which is counted at the decoded slab's bytes, the least
    that round could need."""
    w, c, s, cap = shape["w"], shape["c"], shape["s"], shape["cap"]
    if shape["packed"]:
        return bound_s(*packed_round(w, b, c, s, cap > 0), kind)
    return bound_s(*slab_round(w, b, c, s, cap, decoded=mode != "none"),
                   kind)
