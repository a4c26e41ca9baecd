"""Shared arithmetic of the span readers."""


def mean_ms(record: dict, name: str):
    durs = [d for n, _, d, _ in record["spans"] if n == name]
    return 1e3 * sum(durs) / len(durs) if durs else None
