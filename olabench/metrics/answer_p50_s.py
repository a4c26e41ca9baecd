"""Median latency of the window's queries: every query answered in it and
every one in flight at its close, at the latency it ended with
(``harness/stats.py``), in seconds."""


def read(record: dict):
    e2e = record["e2e"]
    return e2e["answer_p50_s"] if e2e["latency_samples"] else None
