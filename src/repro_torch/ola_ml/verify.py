"""Ingest verification gate: the paper's PTF workflow on training data
(counterpart of ``repro.ola_ml.verify``).

Before a corpus segment is consumed, the verification-query sequence runs
over the segment's raw metadata table with the OLA engine.  Queries stop
as soon as the HAVING predicate is decidable from the confidence bounds
(often after sampling a few % of the rows) — the batch-verification use of
the paper's Section 1, with accelerator time instead of database load time
as the resource being protected.  On a CUDA device each fixed-width ASCII
metadata query's rounds run the fused extraction kernel
(``csrc/slot_extract.cu``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.controller import EstimationController, QueryResult
from repro_torch.core.engine import EngineConfig
from repro_torch.core.queries import Query
from repro_torch.device import resolve_device


@dataclasses.dataclass
class GateDecision:
    admitted: bool
    results: list          # per-query QueryResult
    tuples_ratio: float    # fraction of metadata rows actually extracted
    failed_query: str = ""


class IngestGate:
    """Runs on the CUDA device unless ``device`` says otherwise."""

    def __init__(self, queries: Sequence[Query],
                 config: EngineConfig = EngineConfig(
                     num_workers=4, strategy="resource_aware"),
                 synopsis_budget_tuples: int = 0, device=None):
        self.queries = list(queries)
        self.config = config
        self.synopsis_budget = synopsis_budget_tuples
        self.device = resolve_device(device)

    def check(self, meta_store) -> GateDecision:
        ctrl = EstimationController(
            meta_store, self.config,
            synopsis_budget_tuples=self.synopsis_budget, device=self.device)
        results = ctrl.run_verification(self.queries)
        admitted = len(results) == len(self.queries)
        failed = ""
        for q, r in zip(self.queries, results):
            verdict = int(r.decisions[0])
            ok = verdict == 1 or (verdict == -1 and _exact_pass(q, r))
            if not ok:
                admitted = False
                failed = q.name
                break
        ratio = (sum(r.tuples_ratio for r in results) / max(len(results), 1))
        return GateDecision(admitted=admitted, results=results,
                            tuples_ratio=ratio, failed_query=failed)


def _exact_pass(q: Query, r: QueryResult) -> bool:
    est = float(r.final_estimate[0])
    t = q.having.threshold
    return {"<": est < t, "<=": est <= t, ">": est > t,
            ">=": est >= t}[q.having.op]
