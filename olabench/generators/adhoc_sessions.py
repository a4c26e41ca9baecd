"""Ad-hoc OLA query sessions: the general generator of query traffic.

A traffic file (``olabench/traffic/<mix>.json``) names this module and
gives its parameters.  The generator deals a fixed deck of query specs,
drawn once from ``deck_seed``, in the deck's order (after its last query,
its first again).  The analysts form a closed loop, driven by rounds: the
next query goes to the analyst whose answer came back, so the sequence of
queries, rounds and answers is the same on any host and for any run seed,
and only how much of it fits in a window depends on speed.  (A query's
stopping round depends on the sample it meets after its admission, so
another order of the same deck is other work.  The run's seed varies the
table's layout instead, see ``harness/table.py``.)

Parameters (all in the traffic file):

* ``aggregates``: probability of each of "sum", "count", "avg";
* ``all_columns_share``: probability that the expression is
  ``Linear(1/(k+1))`` over every column; otherwise it is one column drawn
  from ``expression_columns``;
* ``predicate_columns``, ``two_column_share``: a range predicate on one
  column, or on two distinct ones, drawn from ``predicate_columns``;
* ``selectivity``: [lo, hi] of the predicate's selectivity, drawn
  uniformly; a two-column predicate bounds each (independent) column at
  the square root of it.  Bounds are set from the column's own quantiles
  and lie halfway between two neighbouring values of the table, so a
  float32 parse and a float64 parse of a field fall on the same side;
* ``epsilon``: [lo, hi] of the target relative error, drawn uniformly;
* ``deck_size``, ``deck_seed``.

A spec is plain data, shared by the program's queries and the reference.
"""

from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np

from harness import table as tbl


def _bound(cdf: np.ndarray, x: float, step: float):
    """The value bound below which a share ``x`` of the column lies,
    halfway between two neighbouring values; None at the ends."""
    if not 0.0 < x < 1.0:
        return None
    q = int(np.searchsorted(cdf, x))
    return (q + 0.5) * step


def _range(rng, cdf: np.ndarray, sel: float, step: float) -> tuple:
    start = float(rng.uniform(0.0, 1.0 - sel))
    return _bound(cdf, start, step), _bound(cdf, start + sel, step)


def deck(traffic: dict, config: dict) -> list[dict]:
    """The fixed set of query specs this traffic serves."""
    t = config["table"]
    cdfs = tbl.host_cdfs(t)
    step = float(t["vmax"]) / float(t["support"])
    c = int(t["num_cols"])
    rng = np.random.default_rng(int(traffic["deck_seed"]))
    aggs = sorted(traffic["aggregates"])
    p_agg = np.asarray([traffic["aggregates"][a] for a in aggs], float)
    out = []
    for i in range(int(traffic["deck_size"])):
        agg = aggs[int(rng.choice(len(aggs), p=p_agg / p_agg.sum()))]
        if rng.random() < float(traffic["all_columns_share"]):
            coeffs, expr = [1.0 / (k + 1) for k in range(c)], "lin"
        else:
            col = int(rng.choice(traffic["expression_columns"]))
            coeffs = [1.0 if k == col else 0.0 for k in range(c)]
            expr = f"c{col}"
        if agg == "count":
            coeffs, expr = [0.0] * c, "1"
        two = rng.random() < float(traffic["two_column_share"])
        cols = rng.choice(traffic["predicate_columns"], size=2 if two else 1,
                          replace=False)
        sel = float(rng.uniform(*traffic["selectivity"]))
        per_col = sel ** (1.0 / len(cols))
        ranges = [[int(k), *_range(rng, cdfs[int(k)], per_col, step)]
                  for k in cols]
        eps = float(rng.uniform(*traffic["epsilon"]))
        where = "&".join(f"c{k}" for k, _, _ in ranges)
        out.append(dict(id=i, name=f"q{i}-{agg}-{expr}-{where}-{sel:.2f}",
                        agg=agg, coeffs=coeffs, ranges=ranges, epsilon=eps,
                        selectivity=sel))
    return out


def order(deck_len: int) -> Iterator[int]:
    """Deck positions in the order they are dealt."""
    return itertools.cycle(range(deck_len))
