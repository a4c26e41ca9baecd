"""Share of the round kernels' device time that the least time of their
work would take on this card, in %: each profiled round's bytes and
operations from its B, the workers, columns, slots and synopsis cache rows
(``harness/roofline.py``, against the card's published peaks), over the
device time of the round kernels in the same rounds."""

from harness import roofline
from metrics._kernels import round_kernel_s


def read(record: dict):
    prof = record["profile"]
    if not prof or not prof["kernel_args"]:
        return None
    spent = round_kernel_s(prof)
    if not spent:
        return None
    least = sum(roofline.round_bound_s(int(a["b"]), a["mode"],
                                       record["shape"], record["kind"])
                for a in prof["kernel_args"])
    return 100.0 * least / spent
