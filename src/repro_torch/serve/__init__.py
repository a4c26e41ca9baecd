"""Serving plane: the OLA workload server (shared-scan multi-query
serving) and the Tier-1 rollup answer cache that fronts it."""

from repro_torch.serve.ola_server import (
    MeasuredRates,
    OLAWorkloadServer,
    ServerOptions,
    WorkloadQuery,
    WorkloadResult,
    default_rates_path,
    load_measured_rates,
    poisson_workload,
    select_plan,
)
from repro_torch.serve.rollup import RollupConfig, RollupTier, pattern_key

__all__ = ["MeasuredRates", "OLAWorkloadServer", "ServerOptions",
           "WorkloadQuery", "WorkloadResult", "default_rates_path",
           "load_measured_rates", "poisson_workload", "select_plan",
           "RollupConfig", "RollupTier", "pattern_key"]
