"""Share of a round's wall time in which no operation ran on the device,
in %: the device's busy seconds a round over the profiled stretch, against
the unprofiled window's wall seconds a round (the profiler's host work
stretches the rounds it profiles, not the device's)."""


def read(record: dict):
    prof, window = record["profile"], record["window"]
    if not prof or prof["busy_s"] <= 0 or not prof["rounds"] \
            or not window["rounds"]:
        return None
    busy = prof["busy_s"] / prof["rounds"]
    wall = window["seconds"] / window["rounds"]
    return 100.0 * (1.0 - busy / wall)
