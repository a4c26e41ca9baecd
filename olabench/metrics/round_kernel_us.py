"""Device time of the round kernels a round over the profiled stretch, in
microseconds (``torch.profiler``'s device trace)."""

from metrics._kernels import round_kernel_s


def read(record: dict):
    prof = record["profile"]
    if not prof or not prof["kernel_args"]:
        return None
    s = round_kernel_s(prof)
    return None if s is None else 1e6 * s / len(prof["kernel_args"])
