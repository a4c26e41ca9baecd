"""The program's round kernels by the names their CUDA sources give them:
``slot_extract_tiles`` (packed, ``csrc/slot_extract.cu``),
``slab_tiles`` (raw and decoded slabs, ``csrc/slot_extract_stream.cu``)
and ``grouped_tiles`` (``csrc/slot_extract_grouped.cu``)."""

NAMES = ("slot_extract_tiles", "slab_tiles", "grouped_tiles")


def round_kernel_s(profile: dict):
    """Device seconds of the round kernels over the profiled rounds, or
    None when the trace holds none.  A round launches one, a "mixed"
    stream round two; the profiler can lose launch events late in a
    process, so the total is the traced mean a launch times the launches
    the rounds made."""
    spent = launches = 0
    for name, (s, n) in profile["ops"].items():
        if any(k in name for k in NAMES):
            spent += s
            launches += n
    if not launches:
        return None
    made = sum(2 if a["mode"] == "mixed" else 1
               for a in profile["kernel_args"])
    return spent / launches * made
