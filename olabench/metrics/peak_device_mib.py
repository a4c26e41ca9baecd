"""``torch.cuda.max_memory_allocated()`` over the run from the program's
set-up on (the table's generation before it is not counted), in MiB."""


def read(record: dict):
    return record["peak_bytes"] / 2 ** 20
