"""Mean scan rounds an answer of the window spent resident in a slot
(``WorkloadResult.rounds_resident``; 0 for an answer at admission): a
count fixed by the seed, not by the host."""


def read(record: dict):
    rows = record["answers"]
    return sum(r["rounds"] for r in rows) / len(rows) if rows else None
