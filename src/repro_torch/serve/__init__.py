"""Serving plane: the OLA workload server (shared-scan multi-query serving)."""

from repro_torch.serve.ola_server import (
    OLAWorkloadServer,
    ServerOptions,
    WorkloadQuery,
    WorkloadResult,
    poisson_workload,
    select_plan,
)

__all__ = ["OLAWorkloadServer", "ServerOptions", "WorkloadQuery",
           "WorkloadResult", "poisson_workload", "select_plan"]
