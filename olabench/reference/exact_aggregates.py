"""The plain reference: each query's exact answer from the table's bytes.

It parses the fixed-width ASCII layout itself (16 bytes a field: sign, 8
integer digits, '.', 6 fraction digits) into float64 and evaluates every
query's aggregate over every row, in blocks of rows, with plain PyTorch.
It imports nothing of the system under test and sees nothing the system
made: the harness hands it the bytes it generated and the queries as plain
data (see ``olabench/generators``).

A query spec is a dict: ``agg`` ("sum", "count" or "avg"), ``coeffs`` (the
linear expression's coefficient of every column), ``ranges`` (a list of
``[col, lo, hi]`` meaning ``lo <= value < hi``; ``None`` is unbounded).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

FIELD_BYTES = 16
INT_DIGITS = 8
FRAC_DIGITS = 6


def parse_fixed_ascii(raw: torch.Tensor, num_cols: int) -> torch.Tensor:
    """(R, num_cols * 16) uint8 -> (R, num_cols) float64, exact to the
    nearest double of each decimal field."""
    f = raw.reshape(raw.shape[0], num_cols, FIELD_BYTES).to(torch.int64)
    digits = f - ord("0")
    whole = torch.zeros(f.shape[:2], dtype=torch.int64, device=raw.device)
    for d in range(INT_DIGITS):
        whole = whole * 10 + digits[..., 1 + d]
    frac = torch.zeros_like(whole)
    for d in range(FRAC_DIGITS):
        frac = frac * 10 + digits[..., 2 + INT_DIGITS + d]
    micro = whole * 10 ** FRAC_DIGITS + frac
    micro = torch.where(f[..., 0] == ord("-"), -micro, micro).to(torch.float64)
    # a tensor divisor: CUDA turns division by a Python scalar into a product
    # with its reciprocal, which can miss the nearest double by one ulp
    return micro / torch.full_like(micro, 10.0 ** FRAC_DIGITS)


def _plan(specs: Sequence[dict], num_cols: int, device):
    q = len(specs)
    coeffs = torch.zeros((num_cols, q), dtype=torch.float64)
    lo = torch.full((q, num_cols), -float("inf"), dtype=torch.float64)
    hi = torch.full((q, num_cols), float("inf"), dtype=torch.float64)
    for i, s in enumerate(specs):
        coeffs[:, i] = torch.tensor(s["coeffs"], dtype=torch.float64)
        for col, a, b in s["ranges"]:
            if a is not None:
                lo[i, col] = max(float(lo[i, col]), float(a))
            if b is not None:
                hi[i, col] = min(float(hi[i, col]), float(b))
    return coeffs.to(device), lo.to(device), hi.to(device)


def exact_answers(blocks: Iterable[torch.Tensor], specs: Sequence[dict],
                  num_cols: int, query_block: int = 32) -> list[float]:
    """Exact answer of every spec over all rows of ``blocks`` (uint8 byte
    blocks of one table, in any order), in float64."""
    if not specs:
        return []
    sums = counts = plan = None
    for raw in blocks:
        vals = parse_fixed_ascii(raw, num_cols)                 # (R, C)
        if plan is None:
            plan = _plan(specs, num_cols, vals.device)
        coeffs, lo, hi = plan
        x = vals @ coeffs                                       # (R, Q)
        parts_s, parts_c = [], []
        for a in range(0, len(specs), query_block):
            b = a + query_block
            inside = ((vals[:, None, :] >= lo[None, a:b])
                      & (vals[:, None, :] < hi[None, a:b])).all(dim=-1)
            parts_s.append(torch.where(inside, x[:, a:b], 0.0).sum(dim=0))
            parts_c.append(inside.sum(dim=0, dtype=torch.int64))
        s, c = torch.cat(parts_s), torch.cat(parts_c)
        sums = s if sums is None else sums + s
        counts = c if counts is None else counts + c
    out = []
    for spec, s, c in zip(specs, sums.tolist(), counts.tolist()):
        if spec["agg"] == "sum":
            out.append(s)
        elif spec["agg"] == "count":
            out.append(float(c))
        elif spec["agg"] == "avg":
            out.append(s / c if c else float("nan"))
        else:
            raise ValueError(f"unknown aggregate {spec['agg']!r}")
    return out
