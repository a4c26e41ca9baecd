"""OLA-RAW core on PyTorch: estimators, queries, engine, synopsis, controller.

Layering (bottom-up), as in the reference's ``repro.core``:

* :mod:`repro_torch.core.estimators`  — Eq. (1)/(2)/(3) bi-level estimators
  and bounds.
* :mod:`repro_torch.core.queries`     — aggregate-query AST, slot table,
  evaluators.
* :mod:`repro_torch.core.engine`      — the parallel sampling state machine.
* :mod:`repro_torch.core.engine_spmd` — the engine over the ranks of a
  ``torch.distributed`` mesh.
* :mod:`repro_torch.core.synopsis`    — Section 6 memory-resident synopsis.
* :mod:`repro_torch.core.controller`  — δ-interval reporting, verification
  chains, synopsis life-cycle.

The reference's exports are resolved on first access: the data and kernel
modules import pieces of this package, so importing the engine here would
close an import cycle.
"""

import importlib

_EXPORTS = {
    "EstimationController": "controller", "QueryResult": "controller",
    "EngineConfig": "engine", "EngineState": "engine", "OLAEngine": "engine",
    "RoundReport": "engine", "SPMDEngine": "engine_spmd",
    "SlotSPMDEngine": "engine_spmd", "BiLevelStats": "estimators",
    "confidence_bounds": "estimators", "error_ratio": "estimators",
    "having_decision": "estimators", "init_stats": "estimators",
    "tau_hat": "estimators", "var_hat": "estimators", "And": "queries",
    "Cmp": "queries", "Column": "queries", "Custom": "queries",
    "GroupEq": "queries", "Having": "queries", "Linear": "queries",
    "Query": "queries", "Range": "queries", "SquaredDiff": "queries",
    "TRUE": "queries", "expand_group_by": "queries",
    "BiLevelSynopsis": "synopsis",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
