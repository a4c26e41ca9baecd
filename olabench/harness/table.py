"""The raw table, made on the device from the run's seed.

Column k is bounded Zipf with exponent ``s_step * k`` over ``support``
ranks, scaled to [0, vmax] (the distribution of the OLA-RAW paper's §7.1
synthetic dataset).  A value is ``rank_index * vmax / support``; with
``vmax * 10**6`` a multiple of ``support`` every value is a whole number of
millionths, so the ASCII encoding below is exact integer arithmetic.

The layout is fixed-width ASCII, 16 bytes a field: sign, 8 integer digits,
'.', 6 fraction digits.  Chunks are drawn in order from one
``torch.Generator`` on the device, seeded by the configuration, so the same
configuration on the same device gives the same values, and :func:`chunks`
can be called again after the window to hand the reference the very bytes
the program was given.

The run's seed picks the record's layout: the order in which the logical
columns sit in a record (:func:`column_order`).  A query names logical
columns and :func:`place` moves it onto the layout, so every seed asks the
same questions of the same values and the program samples, stops and
answers alike (a linear expression over every column sums its terms in
another order, which can move its last bit), while it parses each column
at another offset of the record and the reference checks it there.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

INT_DIGITS = 8
FRAC_DIGITS = 6
FIELD_BYTES = 1 + INT_DIGITS + 1 + FRAC_DIGITS


def micro_step(table: dict) -> int:
    """Millionths between neighbouring values of a column."""
    num = (int(table["vmax"]) * 10 ** FRAC_DIGITS)
    if num % int(table["support"]):
        raise ValueError("vmax * 1e6 must be a multiple of support")
    return num // int(table["support"])


def chunk_sizes(table: dict) -> list[int]:
    n, t = int(table["num_chunks"]), int(table["num_tuples"])
    base = t // n
    return [base + (1 if j < t - base * n else 0) for j in range(n)]


def zipf_cdfs(table: dict, device, dtype=torch.float64) -> torch.Tensor:
    """(C, support) cumulative distribution of each column's rank index."""
    ranks = torch.arange(1, int(table["support"]) + 1, dtype=dtype,
                         device=device)
    s = float(table["zipf_s_step"]) * torch.arange(
        int(table["num_cols"]), dtype=dtype, device=device)
    cdf = torch.cumsum(ranks[None, :] ** -s[:, None], dim=1)
    return cdf / cdf[:, -1:]


def host_cdfs(table: dict) -> np.ndarray:
    """:func:`zipf_cdfs` in numpy, for the traffic's predicate bounds."""
    ranks = np.arange(1, int(table["support"]) + 1, dtype=np.float64)
    out = []
    for k in range(int(table["num_cols"])):
        cdf = np.cumsum(ranks ** -(float(table["zipf_s_step"]) * k))
        out.append(cdf / cdf[-1])
    return np.stack(out)


def encode_ascii(micro: torch.Tensor) -> torch.Tensor:
    """(R, C) int64 millionths -> (R, C * 16) uint8 fixed-width ASCII."""
    r, c = micro.shape
    out = torch.empty((r, c, FIELD_BYTES), dtype=torch.uint8,
                      device=micro.device)
    out[..., 0] = torch.where(micro < 0, ord("-"), ord("+")).to(torch.uint8)
    mag = micro.abs()
    ip = mag // 10 ** FRAC_DIGITS
    fp = mag % 10 ** FRAC_DIGITS
    if bool((ip >= 10 ** INT_DIGITS).any()):
        raise ValueError("a value does not fit 8 integer digits")
    for d in range(INT_DIGITS):
        out[..., 1 + d] = (ip // 10 ** (INT_DIGITS - 1 - d) % 10
                           + ord("0")).to(torch.uint8)
    out[..., 1 + INT_DIGITS] = ord(".")
    for d in range(FRAC_DIGITS):
        out[..., 2 + INT_DIGITS + d] = (fp // 10 ** (FRAC_DIGITS - 1 - d) % 10
                                        + ord("0")).to(torch.uint8)
    return out.reshape(r, c * FIELD_BYTES)


def column_order(seed: int, num_cols: int) -> list[int]:
    """The logical column at each position of the record, drawn from the
    run's seed."""
    rng = np.random.default_rng([int(seed), 0xC01])
    return [int(k) for k in rng.permutation(num_cols)]


def place(spec: dict, order: list[int]) -> dict:
    """A query spec over logical columns, moved onto the layout ``order``
    (see :func:`column_order`)."""
    at = {k: p for p, k in enumerate(order)}
    return dict(spec, coeffs=[spec["coeffs"][k] for k in order],
                ranges=[[at[int(col)], lo, hi]
                        for col, lo, hi in spec["ranges"]])


def chunks(table: dict, device, order=None) -> Iterator[torch.Tensor]:
    """Each chunk's (rows, C * 16) uint8 bytes on ``device``, in order,
    drawn from the table's ``seed``; the columns laid out in ``order`` (the
    logical column at each position; None keeps 0, 1, ...)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(table["seed"]))
    cdfs = zipf_cdfs(table, device)
    step = micro_step(table)
    c = int(table["num_cols"])
    for rows in chunk_sizes(table):
        u = torch.rand((c, rows), generator=gen, dtype=torch.float64,
                       device=device)
        idx = torch.searchsorted(cdfs, u)            # (C, rows) rank index
        if order is not None:
            idx = idx[order]
        yield encode_ascii(idx.T * step)


def digest(raw: torch.Tensor) -> int:
    """A position-weighted checksum of a chunk's bytes (exact int64)."""
    w = torch.arange(1, raw.shape[1] + 1, dtype=torch.int64,
                     device=raw.device)
    return int((raw.to(torch.int64) * w).sum())
