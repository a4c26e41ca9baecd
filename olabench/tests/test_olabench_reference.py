"""The plain reference against a brute-force float64 sum over a tiny
table, parsed field by field by Python's own float()."""

import numpy as np
import pytest
import torch

from generators import adhoc_sessions as gen
from harness import spec, table
from reference import exact_aggregates as ref

CELL = spec.cell(spec.load(), "zipf16-packed.adhoc")
TINY = dict(CELL.config["table"], num_tuples=3 * 700 + 2, num_chunks=3)


def brute(raw_blocks, q, c):
    total, count = 0.0, 0
    for raw in raw_blocks:
        for row in raw.numpy():
            text = row.tobytes().decode()
            v = [float(text[k * 16:(k + 1) * 16]) for k in range(c)]
            if all((a is None or v[col] >= a) and (b is None or v[col] < b)
                   for col, a, b in q["ranges"]):
                total += sum(w * x for w, x in zip(q["coeffs"], v))
                count += 1
    return {"sum": total, "count": float(count),
            "avg": total / count if count else float("nan")}[q["agg"]]


def test_parse_is_exact():
    raw = next(table.chunks(dict(TINY, seed=5), "cpu"))
    v = ref.parse_fixed_ascii(raw, TINY["num_cols"]).numpy()
    text = raw.numpy()[:50]
    for i, row in enumerate(text):
        s = row.tobytes().decode()
        want = [float(s[k * 16:(k + 1) * 16]) for k in range(16)]
        assert v[i].tolist() == want


def test_parse_reads_signs():
    micro = torch.tensor([[-1234567890123, 5], [0, -7]], dtype=torch.int64)
    raw = table.encode_ascii(micro)
    v = ref.parse_fixed_ascii(raw, 2).numpy()
    assert v.tolist() == [[-1234567.890123, 5e-6], [0.0, -7e-6]]


def test_exact_answers_equal_brute_force():
    deck = gen.deck(CELL.traffic, CELL.config)[:12]
    deck.append(dict(agg="count", coeffs=[0.0] * 16,
                     ranges=[[0, None, None]], epsilon=0.05))
    blocks = list(table.chunks(dict(TINY, seed=9), "cpu"))
    got = ref.exact_answers(iter(blocks), deck, 16, query_block=5)
    for q, g in zip(deck, got):
        want = brute(blocks, q, 16)
        assert g == pytest.approx(want, rel=1e-12, abs=1e-9)
    assert got[-1] == TINY["num_tuples"]


def test_reference_sees_every_block():
    deck = [dict(agg="count", coeffs=[0.0] * 16, ranges=[], epsilon=0.1)]
    blocks = list(table.chunks(dict(TINY, seed=9), "cpu"))
    assert ref.exact_answers(iter(blocks), deck, 16) == [float(
        sum(b.shape[0] for b in blocks))]
    assert np.isnan(ref.exact_answers(iter(blocks), [dict(
        agg="avg", coeffs=[1.0] + [0.0] * 15, ranges=[[0, -2.0, -1.0]],
        epsilon=0.1)], 16)[0])
