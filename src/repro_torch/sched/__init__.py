"""Scan pricing for the workload server (counterpart of ``repro.sched``)."""
