"""95th percentile of the latencies of :mod:`metrics.answer_p50_s`'s
queries, in seconds."""


def read(record: dict):
    e2e = record["e2e"]
    return e2e["answer_p95_s"] if e2e["latency_samples"] else None
