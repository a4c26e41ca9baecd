"""Seconds from the process's start to the window's: the table made and
handed to the program, the kernels built or loaded, the server built and
the warm-up."""


def read(record: dict):
    return record["setup_s"]
