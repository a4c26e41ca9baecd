"""Share of the window's answers the server gave at admission from the
synopsis, with no scan round (``WorkloadResult.from_synopsis``), in %."""


def read(record: dict):
    rows = record["answers"]
    if not rows:
        return None
    return 100.0 * sum(r["from_synopsis"] for r in rows) / len(rows)
