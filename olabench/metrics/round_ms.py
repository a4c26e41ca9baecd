"""Mean host time of the program's ``round`` span over the window (one
``OLAWorkloadServer.step()`` with a round, in ms)."""

from metrics._spans import mean_ms


def read(record: dict):
    return mean_ms(record, "round")
