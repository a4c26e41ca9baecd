"""Query plane: the aggregate-query AST, its evaluators and the slot table
(counterpart of ``repro.core.queries``).

Queries follow the paper's Section 2.2 form::

    SELECT AGGREGATE(expression) FROM T WHERE predicate [HAVING agg <op> thr]

``compile_queries`` lowers a query list to ``cols (..., C) -> (x (Q, ...),
p (Q, ...))``; :func:`linear_plan` extracts the coefficient form the fused
kernel consumes; :class:`SlotTable` is the data-driven counterpart the
workload server writes rows into between rounds.

GROUP BY is not part of this package yet: ``Query(group_by=...)`` raises
``NotImplementedError``, and the slot table's group columns are zero-width.
Linear expressions accumulate their terms in column order, the order the
reference's f32 contraction takes on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.estimators import (HAVING_NONE, HAVING_OP_CODES,
                                         z_score)


def _fma(acc, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``acc + a·b`` rounded to f32 once: the product of two f32 values is
    exact in float64 (``acc=None`` starts a sum)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    if acc is not None:
        p = acc.to(torch.float64) + p
    return p.to(torch.float32)


def _dot_seq(cols: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """``cols (..., K) · coeffs (K,) -> (...)``: one fused multiply-add per
    term in column order (the reference's f32 matrix-vector order on the
    CPU, for :class:`Linear`)."""
    acc = None
    for k in range(coeffs.shape[0]):
        acc = _fma(acc, cols[..., k], coeffs[k])
    return acc


def _lin(cols: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """``cols (..., C) · coeffs (S, C)ᵀ -> (..., S)`` for the slot table: four
    interleaved fused multiply-add chains (column c feeds chain c mod 4),
    combined pairwise.  That is the order the reference's f32 contraction
    takes on the CPU when C is a multiple of 4, so the slot plane agrees
    with it bit for bit there; f32 sums round, so the order is part of the
    contract."""
    chains = []
    for lane in range(min(4, coeffs.shape[1])):
        acc = None
        for c in range(lane, coeffs.shape[1], 4):
            acc = _fma(acc, cols[..., None, c], coeffs[:, c])
        chains.append(acc)
    while len(chains) > 1:
        chains = [chains[i] + chains[i + 1] if i + 1 < len(chains)
                  else chains[i] for i in range(0, len(chains), 2)]
    return chains[0]


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Linear:
    """``Σ_k coeffs[k] · col_k``."""

    coeffs: tuple[float, ...]

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        c = torch.tensor(self.coeffs, dtype=cols.dtype, device=cols.device)
        return _dot_seq(cols, c)


@dataclasses.dataclass(frozen=True)
class Column:
    """A single column reference, e.g. ``T.a``."""

    index: int

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        return cols[..., self.index]


@dataclasses.dataclass(frozen=True)
class SquaredDiff:
    """``(T.a - T.b)^2`` — the paper's example of a non-linear expression."""

    a: int
    b: int

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        d = cols[..., self.a] - cols[..., self.b]
        return d * d


@dataclasses.dataclass(frozen=True)
class Custom:
    """Arbitrary tensor expression ``f(cols (..., C)) -> (...)``."""

    fn: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        return self.fn(cols)


ONE = Custom(fn=lambda cols: torch.ones(cols.shape[:-1], dtype=cols.dtype,
                                        device=cols.device))
"""Expression ``1`` — COUNT is SUM with expression = 1 (Section 4.3)."""


# ---------------------------------------------------------------------------
# Predicates (conjunctions of simple terms)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Range:
    """``lo <= col < hi``."""

    col: int
    lo: float = -np.inf
    hi: float = np.inf

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        c = cols[..., self.col]
        return (c >= self.lo) & (c < self.hi)


@dataclasses.dataclass(frozen=True)
class Cmp:
    col: int
    op: str  # one of < <= > >= == !=
    value: float

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        c = cols[..., self.col]
        v = torch.tensor(self.value, dtype=cols.dtype, device=cols.device)
        return {
            "<": c < v, "<=": c <= v, ">": c > v, ">=": c >= v,
            "==": c == v, "!=": c != v,
        }[self.op]


@dataclasses.dataclass(frozen=True)
class And:
    terms: tuple

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        out = torch.ones(cols.shape[:-1], dtype=torch.bool, device=cols.device)
        for t in self.terms:
            out = out & t(cols)
        return out


TRUE = And(terms=())


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Having:
    op: str  # < <= > >=
    threshold: float


@dataclasses.dataclass(frozen=True)
class Query:
    """One OLA query: ``epsilon`` is the target error ratio, ``confidence``
    the CI level (Section 2.2's user parameters)."""

    agg: str  # 'sum' | 'count' | 'avg'
    expr: object = ONE
    pred: object = TRUE
    having: Having | None = None
    epsilon: float = 0.05
    confidence: float = 0.95
    name: str = "q"
    group_by: object = None

    def __post_init__(self):
        if self.agg not in ("sum", "count", "avg"):
            raise ValueError(f"unsupported aggregate: {self.agg}")
        if self.group_by is not None:
            raise NotImplementedError(
                "GROUP BY is not ported to repro_torch yet")

    @property
    def columns_used(self) -> frozenset[int]:
        """Columns the query touches — drives synopsis reuse (Section 6)."""
        cols: set[int] = set()

        def walk(node):
            if isinstance(node, Linear):
                cols.update(range(len(node.coeffs)))
            elif isinstance(node, Column):
                cols.add(node.index)
            elif isinstance(node, SquaredDiff):
                cols.update((node.a, node.b))
            elif isinstance(node, Custom):
                cols.add(-1)  # unknown support: requires all columns
            elif isinstance(node, (Range, Cmp)):
                cols.add(node.col)
            elif isinstance(node, And):
                for t in node.terms:
                    walk(t)

        walk(self.expr)
        walk(self.pred)
        return frozenset(cols)


def compile_queries(queries: Sequence[Query]) -> Callable:
    """Lower queries to ``cols (..., C) -> (x (Q, ...), p (Q, ...))``: ``x``
    is the predicate-masked expression (1 for COUNT), ``p`` the 0/1
    predicate indicator."""
    qs = tuple(queries)

    def evaluate(cols: torch.Tensor):
        xs, ps = [], []
        for q in qs:
            pf = q.pred(cols).to(cols.dtype)
            if q.agg == "count":
                e = torch.ones(cols.shape[:-1], dtype=cols.dtype,
                               device=cols.device)
            else:
                e = torch.as_tensor(q.expr(cols)).to(cols.dtype)
            xs.append(e * pf)
            ps.append(pf)
        return torch.stack(xs, dim=0), torch.stack(ps, dim=0)

    return evaluate


@dataclasses.dataclass(frozen=True)
class LinearPlan:
    """Coefficient form: ``coeffs (Q, C)`` and per-column predicate bounds
    ``lo/hi (Q, C)`` (±inf for unconstrained columns), numpy f32."""

    coeffs: np.ndarray
    lo: np.ndarray
    hi: np.ndarray

    @property
    def num_queries(self) -> int:
        return self.coeffs.shape[0]


def _next_up(v: np.float32) -> np.float32:
    """The next float32 above ``v`` (``torch.nextafter`` in float32)."""
    t = torch.tensor(float(v), dtype=torch.float32)
    return np.float32(torch.nextafter(t, torch.tensor(float("inf"))).item())


def linear_plan(queries: Sequence[Query], num_cols: int) -> LinearPlan:
    """Extract the coefficient form, or raise if a query is not linear+range.

    The lowering is exact in f32 (values are compared as ``lo <= c < hi``):
    closed upper bounds and strict lower bounds shift by one f32 ulp, ``==``
    becomes ``[v, v⁺)``, and ``!=`` has no conjunctive-range form and
    raises."""
    q_n = len(queries)
    coeffs = np.zeros((q_n, num_cols), np.float32)
    lo = np.full((q_n, num_cols), -np.inf, np.float32)
    hi = np.full((q_n, num_cols), np.inf, np.float32)
    tiny = np.finfo(np.float32).tiny
    for qi, q in enumerate(queries):
        if q.agg == "count":
            pass  # coeffs stay zero; count comes from the predicate
        elif isinstance(q.expr, Linear):
            coeffs[qi, : len(q.expr.coeffs)] = q.expr.coeffs
        elif isinstance(q.expr, Column):
            coeffs[qi, q.expr.index] = 1.0
        else:
            raise ValueError(f"query {q.name}: expression not linear, "
                             "use the plain evaluator path")

        def add_pred(node):
            if isinstance(node, And):
                for t in node.terms:
                    add_pred(t)
            elif isinstance(node, Range):
                lo[qi, node.col] = max(lo[qi, node.col], node.lo)
                hi[qi, node.col] = min(hi[qi, node.col], node.hi)
            elif isinstance(node, Cmp):
                op = node.op
                v = np.float32(node.value)
                up = _next_up(v)
                if up != 0 and abs(up) < tiny:
                    # a denormal bound would flush to zero on devices with
                    # FTZ and empty the range; the smallest normal float is
                    # exact for decoded data (nonzero magnitudes >= 1e-6)
                    up = np.float32(np.copysign(tiny, up))
                if op == "<":
                    hi[qi, node.col] = min(hi[qi, node.col], v)
                elif op == "<=":    # c <= v  ≡  c < nextafter(v)
                    hi[qi, node.col] = min(hi[qi, node.col], up)
                elif op == ">":     # c > v   ≡  c >= nextafter(v)
                    lo[qi, node.col] = max(lo[qi, node.col], up)
                elif op == ">=":
                    lo[qi, node.col] = max(lo[qi, node.col], v)
                elif op == "==":
                    lo[qi, node.col] = max(lo[qi, node.col], v)
                    hi[qi, node.col] = min(hi[qi, node.col], up)
                else:
                    raise ValueError(
                        f"query {q.name}: {op!r} is not range-encodable, "
                        "use the plain evaluator path")
            else:
                raise ValueError(
                    f"query {q.name}: predicate not range-conjunctive")

        add_pred(q.pred)
    return LinearPlan(coeffs=coeffs, lo=lo, hi=hi)


# ---------------------------------------------------------------------------
# Dynamic query slot table (workload serving)
# ---------------------------------------------------------------------------

AGG_SUM, AGG_COUNT, AGG_AVG = 0, 1, 2
_AGG_CODES = {"sum": AGG_SUM, "count": AGG_COUNT, "avg": AGG_AVG}

PLAN_CHUNK_LEVEL, PLAN_HOLISTIC, PLAN_SINGLE_PASS, PLAN_RESOURCE_AWARE = 0, 1, 2, 3
PLAN_CODES = {"chunk_level": PLAN_CHUNK_LEVEL, "holistic": PLAN_HOLISTIC,
              "single_pass": PLAN_SINGLE_PASS,
              "resource_aware": PLAN_RESOURCE_AWARE}


class SlotTable(NamedTuple):
    """Per-slot query descriptors, all tensors of leading dim S on the
    engine's device.  ``gcol/gval/gact/gtopk`` are the grouped plane's
    columns, carried zero-width (G = 0) until GROUP BY is ported."""

    coeffs: torch.Tensor      # (S, C) f32
    lo: torch.Tensor          # (S, C) f32
    hi: torch.Tensor          # (S, C) f32
    agg: torch.Tensor         # (S,) int32  AGG_* code
    plan: torch.Tensor        # (S,) int32  PLAN_* code
    eps: torch.Tensor         # (S,) f32 target error ratio
    z: torch.Tensor           # (S,) f32 z-score of the slot's confidence
    having_op: torch.Tensor   # (S,) int32  HAVING_OP_CODES or HAVING_NONE
    having_thr: torch.Tensor  # (S,) f32
    active: torch.Tensor      # (S,) bool
    weight: torch.Tensor      # (S,) f32 fairness share in (0, 1]
    gcol: torch.Tensor        # (S,) int32, -1 = ungrouped
    gval: torch.Tensor        # (S, 0) f32
    gact: torch.Tensor        # (S, 0) f32
    gtopk: torch.Tensor       # (S,) int32

    @property
    def max_slots(self) -> int:
        return int(self.agg.shape[0])


def empty_slot_table(max_slots: int, num_cols: int,
                     device=None) -> SlotTable:
    """All-inactive table; inactive slots have an always-false predicate."""
    s, c = int(max_slots), int(num_cols)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return SlotTable(
        coeffs=full((s, c), 0.0, torch.float32),
        lo=full((s, c), float("inf"), torch.float32),   # empty range
        hi=full((s, c), float("-inf"), torch.float32),
        agg=full((s,), 0, torch.int32),
        plan=full((s,), PLAN_RESOURCE_AWARE, torch.int32),
        eps=full((s,), 1.0, torch.float32),
        z=full((s,), 1.959964, torch.float32),   # 95% placeholder
        having_op=full((s,), HAVING_NONE, torch.int32),
        having_thr=full((s,), 0.0, torch.float32),
        active=full((s,), False, torch.bool),
        weight=full((s,), 1.0, torch.float32),
        gcol=full((s,), -1, torch.int32),
        gval=full((s, 0), 0.0, torch.float32),
        gact=full((s, 0), 0.0, torch.float32),
        gtopk=full((s,), 0, torch.int32),
    )


def encode_slot(query: Query, num_cols: int,
                plan: str = "resource_aware") -> dict:
    """Encode one linear+range query as a slot-table row (numpy scalars and
    rows).  Raises ``ValueError`` for queries outside the coefficient form."""
    lp = linear_plan([query], num_cols)
    hop = (HAVING_NONE if query.having is None
           else HAVING_OP_CODES[query.having.op])
    thr = 0.0 if query.having is None else float(query.having.threshold)
    return dict(
        coeffs=lp.coeffs[0], lo=lp.lo[0], hi=lp.hi[0],
        agg=np.int32(_AGG_CODES[query.agg]),
        plan=np.int32(PLAN_CODES[plan]),
        eps=np.float32(query.epsilon),
        z=np.float32(z_score(query.confidence).item()),
        having_op=np.int32(hop), having_thr=np.float32(thr),
        active=True, weight=np.float32(1.0),
    )


def slot_table_set(table: SlotTable, s: int, row: dict) -> SlotTable:
    """Row write (host-side, between rounds); returns a new table."""
    out = SlotTable(*(t.clone() for t in table))
    dev = out.coeffs.device
    out.coeffs[s] = torch.as_tensor(row["coeffs"], dtype=torch.float32,
                                    device=dev)
    out.lo[s] = torch.as_tensor(row["lo"], dtype=torch.float32, device=dev)
    out.hi[s] = torch.as_tensor(row["hi"], dtype=torch.float32, device=dev)
    out.agg[s] = int(row["agg"])
    out.plan[s] = int(row["plan"])
    out.eps[s] = float(np.float32(row["eps"]))
    out.z[s] = float(np.float32(row["z"]))
    out.having_op[s] = int(row["having_op"])
    out.having_thr[s] = float(np.float32(row["having_thr"]))
    out.active[s] = bool(row["active"])
    out.weight[s] = float(np.float32(row.get("weight", 1.0)))
    out.gcol[s] = -1
    out.gtopk[s] = 0
    return out


def slot_table_clear(table: SlotTable, s: int) -> SlotTable:
    """Deactivate a slot; descriptors stay so the final round's report for
    the slot stays readable, and the fairness weight resets to 1.0."""
    active = table.active.clone()
    weight = table.weight.clone()
    active[s] = False
    weight[s] = 1.0
    return table._replace(active=active, weight=weight)


def slot_evaluate(table: SlotTable, cols: torch.Tensor):
    """Data-driven evaluator ``cols (..., C) -> (x, p) (S, ...)``: ``p`` is
    the conjunctive-range indicator, ``x`` the predicate-masked expression
    (1 for COUNT slots).  Inactive slots have an empty range and so give
    all-zero rows."""
    dtype = cols.dtype
    c = cols[..., None, :]                                      # (..., 1, C)
    inb = (c >= table.lo.to(dtype)) & (c < table.hi.to(dtype))
    p = torch.all(inb, dim=-1)                                  # (..., S)
    lin = _lin(cols, table.coeffs.to(dtype))                    # (..., S)
    is_count = table.agg == AGG_COUNT
    expr = torch.where(is_count, torch.ones_like(lin), lin)
    pf = p.to(dtype)
    x = expr * pf
    return torch.movedim(x, -1, 0), torch.movedim(pf, -1, 0)
