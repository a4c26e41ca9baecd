"""Eq. (4) scan pricing for the workload server (counterpart of the pricing
half of ``repro.sched.admission``).

Only the two functions the unscheduled server uses live here: the Eq. (4)
cost terms of one full pass (plan selection, explain records) and the
overlapped-pipeline scan rate.  The SLO admission controller arrives with
the scheduler slice.
"""

from __future__ import annotations


def eq4_cost_terms(store, config, rates=None, *, total_bytes=None,
                   total_tuples=None, decoded_fraction: float = 0.0) -> tuple:
    """The two Eq. (4) cost terms for one full pass over ``store`` —
    ``(T_io, T_cpu)`` modeled seconds — on measured rates when available
    (worker-count and codec-cost rescaled), modeled constants otherwise.

    ``total_bytes``/``total_tuples`` override the store totals (the server
    prices a surviving population after chunk quarantine);
    ``decoded_fraction`` discounts the CPU term by the share of tuples a
    decoded-chunk cache holds."""
    if total_bytes is None:
        total_bytes = float(store.chunk_sizes.sum()) * store.codec.record_bytes
    if total_tuples is None:
        total_tuples = float(store.num_tuples)
    total_bytes, total_tuples = float(total_bytes), float(total_tuples)
    if rates is not None:
        t_io = total_bytes / rates.io_bytes_per_sec
        # the measured tuple rate is aggregate over the calibration run's
        # worker count; extraction scales with workers, reads do not
        cpu_rate = rates.cpu_tuples_per_sec * config.num_workers / rates.workers
        # tuples/s is codec-relative: rescale by the extraction-cost ratio
        if rates.cost_per_tuple > 0:
            cpu_rate *= (rates.cost_per_tuple
                         / max(store.codec.extract_cost_per_tuple(), 1e-12))
        t_cpu = total_tuples / cpu_rate
    else:
        t_io = total_bytes / config.io_bytes_per_sec
        t_cpu = (total_tuples * store.codec.extract_cost_per_tuple()
                 / config.cpu_tuple_ops_per_sec / config.num_workers)
    t_cpu *= 1.0 - min(max(float(decoded_fraction), 0.0), 1.0)
    return t_io, t_cpu


def scan_tuples_per_s(store, config, rates=None, *, total_bytes=None,
                      total_tuples=None, decoded_fraction: float = 0.0
                      ) -> float:
    """Aggregate scan throughput (tuples per modeled second) for a full
    pass: the Eq. (4) overlapped-pipeline rate ``total / max(T_io, T_cpu)``."""
    t_io, t_cpu = eq4_cost_terms(store, config, rates,
                                 total_bytes=total_bytes,
                                 total_tuples=total_tuples,
                                 decoded_fraction=decoded_fraction)
    n = float(store.num_tuples) if total_tuples is None else float(total_tuples)
    return n / max(t_io, t_cpu, 1e-12)
