"""Query plane: the aggregate-query AST, its evaluators and the slot table
(counterpart of ``repro.core.queries``).

Queries follow the paper's Section 2.2 form::

    SELECT AGGREGATE(expression) FROM T WHERE predicate [HAVING agg <op> thr]

``compile_queries`` lowers a query list to ``cols (..., C) -> (x (Q, ...),
p (Q, ...))``; :func:`linear_plan` extracts the coefficient form the fused
kernel consumes; :class:`SlotTable` is the data-driven counterpart the
workload server writes rows into between rounds.

``Query(group_by=GroupBy(...))`` is an online GROUP BY: the slot table
carries per-slot group columns (``gcol/gval/gact/gtopk``, G = max_groups + 1
cells of which the last is the ``__other__`` spill), zero-width when the
table has no group capacity.  :func:`group_fanout` is the Section 2.2
expansion the grouped plane is checked against.  Linear expressions
accumulate their terms in column order, the order the reference's f32
contraction takes on the CPU.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

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
class GroupEq:
    """Group-membership predicate ``col == value`` (the conjunct
    :func:`group_fanout` adds)."""

    col: int
    value: float

    def __call__(self, cols: torch.Tensor) -> torch.Tensor:
        return cols[..., self.col] == torch.tensor(
            self.value, dtype=cols.dtype, device=cols.device)


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
class GroupBy:
    """Online GROUP BY over one column, bounded at ``max_groups`` cells.

    Up to ``max_groups`` distinct values get cells of their own with their
    own sufficient statistics and CIs; values are discovered online by a
    bounded heavy-hitter sketch fed from per-round group tallies, and every
    untracked value spills into an ``__other__`` cell.  The query retires
    when its ``top_k`` largest cells (by |estimate|) meet its epsilon.
    ``values`` pins known group values into cells at admission: pinned cells
    accumulate from the first round and equal the :func:`group_fanout`
    expansion bit for bit."""

    col: int
    max_groups: int = 8
    top_k: int = 0  # 0 -> all max_groups cells must converge
    values: Optional[tuple[float, ...]] = None

    def __post_init__(self):
        if self.max_groups < 1:
            raise ValueError("GroupBy.max_groups must be >= 1")
        if not (0 <= self.top_k <= self.max_groups):
            raise ValueError("GroupBy.top_k must be in [0, max_groups]")
        if self.values is not None:
            vals = tuple(float(v) for v in self.values)
            if len(vals) > self.max_groups:
                raise ValueError(
                    f"GroupBy: {len(vals)} pinned values exceed "
                    f"max_groups={self.max_groups}")
            if len(set(vals)) != len(vals):
                raise ValueError("GroupBy: pinned values must be distinct")
            object.__setattr__(self, "values", vals)

    @property
    def effective_top_k(self) -> int:
        return self.top_k if self.top_k > 0 else self.max_groups


@dataclasses.dataclass(frozen=True)
class GroupResult:
    """One cell of a grouped answer (``WorkloadResult.groups``): ``value``
    is the group's column value (NaN for the ``__other__`` spill, flagged by
    ``is_other``), ``n`` the tuples sampled while the cell was live,
    ``decision`` the cell's HAVING verdict (1 / 0 / -1 undecided or none)."""

    value: float
    estimate: float
    lo: float
    hi: float
    err: float
    n: int
    decision: int = -1
    is_other: bool = False


@dataclasses.dataclass(frozen=True)
class Query:
    """One OLA query: ``epsilon`` is the target error ratio, ``confidence``
    the CI level (Section 2.2's user parameters).  With ``group_by`` the
    scalar ``estimate/lo/hi`` describe the base-predicate population and
    the per-group answers arrive as ``WorkloadResult.groups``."""

    agg: str  # 'sum' | 'count' | 'avg'
    expr: object = ONE
    pred: object = TRUE
    having: Having | None = None
    epsilon: float = 0.05
    confidence: float = 0.95
    name: str = "q"
    group_by: Optional[GroupBy] = None

    def __post_init__(self):
        if self.agg not in ("sum", "count", "avg"):
            raise ValueError(f"unsupported aggregate: {self.agg}")
        if self.group_by is not None and not isinstance(self.group_by,
                                                        GroupBy):
            raise TypeError("Query.group_by must be a GroupBy (or None)")

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
            elif isinstance(node, (Range, Cmp, GroupEq)):
                cols.add(node.col)
            elif isinstance(node, And):
                for t in node.terms:
                    walk(t)

        walk(self.expr)
        walk(self.pred)
        if self.group_by is not None:
            cols.add(self.group_by.col)
        return frozenset(cols)


def group_fanout(base: Query, group_col: int, group_values: Sequence[float],
                 ) -> list[Query]:
    """GROUP BY as Section 2.2 prescribes it: one scalar query per known
    group value, identical but for a group-membership conjunct.  The grouped
    slot plane is checked against this expansion."""
    out = []
    for v in group_values:
        pred = And(terms=(base.pred, GroupEq(group_col, float(v))))
        out.append(dataclasses.replace(base, pred=pred, group_by=None,
                                       name=f"{base.name}[g={v}]"))
    return out


def expand_group_by(base: Query, group_col: int, group_values: Sequence[float],
                    ) -> list[Query]:
    """Deprecated: write ``Query(group_by=GroupBy(col, max_groups, top_k))``
    and read ``WorkloadResult.groups``.  Delegates to :func:`group_fanout`
    after a ``DeprecationWarning``."""
    warnings.warn(
        "expand_group_by is deprecated; use "
        "Query(group_by=GroupBy(col, max_groups, top_k)) and read "
        "WorkloadResult.groups",
        DeprecationWarning, stacklevel=2)
    return group_fanout(base, group_col, group_values)


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
            elif isinstance(node, (GroupEq, Cmp)):
                op = "==" if isinstance(node, GroupEq) else node.op
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
    columns: G = max_groups + 1 cells per slot, the last the ``__other__``
    spill, or G = 0 for a table without group capacity."""

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
    gcol: torch.Tensor        # (S,) int32 group-by column, -1 = ungrouped
    gval: torch.Tensor        # (S, G) f32 tracked group values
    gact: torch.Tensor        # (S, G) f32 0/1 live cells; cell G-1 = __other__
    gtopk: torch.Tensor       # (S,) int32 cells that must meet eps to stop

    @property
    def max_slots(self) -> int:
        return int(self.agg.shape[0])

    @property
    def group_cells(self) -> int:
        """G: cells per slot including ``__other__`` (0 = ungrouped)."""
        return int(self.gval.shape[1])


def empty_slot_table(max_slots: int, num_cols: int, max_groups: int = 0,
                     device=None) -> SlotTable:
    """All-inactive table; inactive slots have an always-false predicate.
    ``max_groups > 0`` gives every slot ``max_groups`` tracked cells plus the
    ``__other__`` cell; 0 keeps the group columns zero-width."""
    s, c = int(max_slots), int(num_cols)
    g = int(max_groups) + 1 if int(max_groups) > 0 else 0

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
        gval=full((s, g), 0.0, torch.float32),
        gact=full((s, g), 0.0, torch.float32),
        gtopk=full((s,), 0, torch.int32),
    )


def encode_slot(query: Query, num_cols: int, plan: str = "resource_aware",
                max_groups: int = 0) -> dict:
    """Encode one linear+range query as a slot-table row (numpy scalars and
    rows).  ``max_groups`` is the table's group capacity; a grouped query
    asking for more cells raises.  Pinned ``GroupBy.values`` are live in
    cells ``0..k-1`` from admission, and the ``__other__`` cell (last) is
    live for every grouped slot.  Raises ``ValueError`` for queries outside
    the coefficient form."""
    lp = linear_plan([query], num_cols)
    hop = (HAVING_NONE if query.having is None
           else HAVING_OP_CODES[query.having.op])
    thr = 0.0 if query.having is None else float(query.having.threshold)
    g = int(max_groups) + 1 if int(max_groups) > 0 else 0
    gcol, gtopk = -1, 0
    gval = np.zeros((g,), np.float32)
    gact = np.zeros((g,), np.float32)
    gb = query.group_by
    if gb is not None:
        if gb.max_groups > int(max_groups):
            raise ValueError(
                f"query {query.name}: group_by.max_groups={gb.max_groups} "
                f"exceeds the slot table's max_groups={int(max_groups)}")
        if not (0 <= gb.col < num_cols):
            raise ValueError(
                f"query {query.name}: group_by column {gb.col} out of range")
        gcol, gtopk = gb.col, gb.effective_top_k
        gact[g - 1] = 1.0  # __other__ live from admission
        for i, v in enumerate(gb.values or ()):
            gval[i] = np.float32(v)
            gact[i] = 1.0
    return dict(
        coeffs=lp.coeffs[0], lo=lp.lo[0], hi=lp.hi[0],
        agg=np.int32(_AGG_CODES[query.agg]),
        plan=np.int32(PLAN_CODES[plan]),
        eps=np.float32(query.epsilon),
        z=np.float32(z_score(query.confidence).item()),
        having_op=np.int32(hop), having_thr=np.float32(thr),
        active=True, weight=np.float32(1.0),
        gcol=np.int32(gcol), gval=gval, gact=gact, gtopk=np.int32(gtopk),
    )


def slot_table_set(table: SlotTable, s: int, row: dict) -> SlotTable:
    """Row write (host-side, between rounds); returns a new table.  Group
    columns fall back to the ungrouped row (``gcol=-1``, no live cell) when
    absent or sized for another capacity."""
    out = SlotTable(*(t.clone() for t in table))
    dev = out.coeffs.device
    g = table.group_cells
    gval_row = np.asarray(row.get("gval", ()), np.float32).reshape(-1)
    gact_row = np.asarray(row.get("gact", ()), np.float32).reshape(-1)
    if gval_row.shape != (g,) or gact_row.shape != (g,):
        gval_row = np.zeros((g,), np.float32)
        gact_row = np.zeros((g,), np.float32)
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
    out.gcol[s] = int(row.get("gcol", -1))
    out.gval[s] = torch.as_tensor(gval_row, device=dev)
    out.gact[s] = torch.as_tensor(gact_row, device=dev)
    out.gtopk[s] = int(row.get("gtopk", 0))
    return out


def slot_table_set_groups(table: SlotTable, s: int, gval_row,
                          gact_row) -> SlotTable:
    """Group-cell write for slot ``s`` (online discovery promotes sketch
    heavy hitters into free cells between rounds): only ``gval`` and
    ``gact`` change."""
    gval, gact = table.gval.clone(), table.gact.clone()
    gval[s] = torch.as_tensor(np.asarray(gval_row, np.float32),
                              device=gval.device)
    gact[s] = torch.as_tensor(np.asarray(gact_row, np.float32),
                              device=gact.device)
    return table._replace(gval=gval, gact=gact)


def slot_table_clear(table: SlotTable, s: int) -> SlotTable:
    """Deactivate a slot; descriptors stay so the final round's report for
    the slot stays readable, and the fairness weight resets to 1.0."""
    active = table.active.clone()
    weight = table.weight.clone()
    active[s] = False
    weight[s] = 1.0
    return table._replace(active=active, weight=weight)


def slot_table_from_numpy(table, device=None) -> SlotTable:
    """A :class:`SlotTable` on ``device`` from any table with the same
    fields holding array-likes (the reference package's table, read with
    ``numpy.asarray``), group columns included."""
    return SlotTable(*(torch.as_tensor(np.array(getattr(table, f)),
                                       device=device)
                       for f in SlotTable._fields))


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
