"""The traffic generator and the table: the same deck in the same order for
every seed, its predicate bounds where they say they are; the table's
values fixed by the configuration and its column layout by the run's
seed."""

import itertools

import pytest

from generators import adhoc_sessions as gen
from harness import spec, table

CELL = spec.cell(spec.load(), "zipf16-packed.adhoc")
TRAFFIC, CONFIG = CELL.traffic, CELL.config


def test_deck_is_fixed_by_the_traffic_file():
    a = gen.deck(TRAFFIC, CONFIG)
    b = gen.deck(TRAFFIC, CONFIG)
    assert a == b and len(a) == TRAFFIC["deck_size"]


def test_order_deals_the_deck_in_order_pass_after_pass():
    n = TRAFFIC["deck_size"]
    dealt = list(itertools.islice(gen.order(n), 3 * n))
    assert dealt == list(range(n)) * 3


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 62 + 1])
def test_layout_is_deterministic_by_seed(seed):
    c = CONFIG["table"]["num_cols"]
    first = table.column_order(seed, c)
    assert first == table.column_order(seed, c)
    assert first != table.column_order(seed + 1, c)
    assert sorted(first) == list(range(c))


def test_a_placed_query_reads_the_same_values():
    """Laid out in another order, a query's columns, coefficients and
    bounds meet the same values: the reference's answer is the same."""
    from reference.exact_aggregates import exact_answers

    t = dict(CONFIG["table"], num_tuples=4 * 1024, num_chunks=4)
    deck = gen.deck(TRAFFIC, CONFIG)[:24]
    plain = exact_answers(table.chunks(t, "cpu"), deck, t["num_cols"])
    order = table.column_order(2 ** 31 + 3, t["num_cols"])
    moved = exact_answers(table.chunks(t, "cpu", order),
                          [table.place(q, order) for q in deck],
                          t["num_cols"])
    assert moved == pytest.approx(plain, rel=1e-12)


def test_deck_follows_the_mix():
    deck = gen.deck(TRAFFIC, CONFIG)
    c = CONFIG["table"]["num_cols"]
    lo, hi = TRAFFIC["epsilon"]
    for q in deck:
        assert q["agg"] in TRAFFIC["aggregates"]
        assert lo <= q["epsilon"] <= hi
        assert len(q["coeffs"]) == c
        assert 1 <= len(q["ranges"]) <= 2
        assert {r[0] for r in q["ranges"]} <= set(TRAFFIC["predicate_columns"])
        if q["agg"] == "count":
            assert not any(q["coeffs"])


def test_bounds_lie_halfway_between_values_and_give_the_selectivity():
    t = CONFIG["table"]
    step = t["vmax"] / t["support"]
    cdfs = table.host_cdfs(t)
    for q in gen.deck(TRAFFIC, CONFIG):
        share = 1.0
        for col, a, b in q["ranges"]:
            for bound in (a, b):
                if bound is not None:
                    assert abs(bound / step % 1.0 - 0.5) < 1e-9
            p_hi = 1.0 if b is None else cdfs[col][int(b / step)]
            p_lo = 0.0 if a is None else cdfs[col][int(a / step)]
            share *= p_hi - p_lo
        # the quantile grid is fine on columns 0-3: within 2% of the mix's
        assert abs(share - q["selectivity"]) < 0.02


def test_table_is_deterministic_by_seed_and_encodes_exactly():
    t = dict(CONFIG["table"], num_tuples=4 * 257, num_chunks=4)
    a = [table.digest(r) for r in table.chunks(dict(t, seed=11), "cpu")]
    b = [table.digest(r) for r in table.chunks(dict(t, seed=11), "cpu")]
    c = [table.digest(r) for r in table.chunks(dict(t, seed=12), "cpu")]
    assert a == b and a != c
    raw = next(table.chunks(dict(t, seed=11), "cpu")).numpy()
    text = raw[0].tobytes().decode()
    fields = [text[k:k + 16] for k in range(0, len(text), 16)]
    step = table.micro_step(t)
    for f in fields:
        assert f[0] == "+" and f[9] == "." and len(f) == 16
        micro = int(f[1:9]) * 10 ** 6 + int(f[10:])
        assert micro % step == 0 and micro <= t["vmax"] * 10 ** 6


def test_column_zero_is_uniform_and_column_three_skewed():
    t = dict(CONFIG["table"], num_tuples=65536, num_chunks=1)
    raw = next(table.chunks(dict(t, seed=3), "cpu")).numpy()
    from reference.exact_aggregates import parse_fixed_ascii
    import torch
    v = parse_fixed_ascii(torch.from_numpy(raw), t["num_cols"]).numpy()
    assert abs(v[:, 0].mean() / 5e7 - 1.0) < 0.02
    assert v[:, 3].mean() < 0.5 * v[:, 0].mean()
    assert (v[:, 15] == 0).mean() > 0.85
