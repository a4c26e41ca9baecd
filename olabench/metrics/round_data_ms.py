"""Mean host time of the program's ``claims`` span over the window: the
data feed, ``engine.round_data`` (claim prediction, slab reads, the
decoded cache, the copy to the device), in ms.  About 0 under packed
residency, where it returns the resident store."""

from metrics._spans import mean_ms


def read(record: dict):
    return mean_ms(record, "claims")
