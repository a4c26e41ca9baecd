"""The OLA system's examples on the port (counterparts of the repository's
``examples/``), each runnable as ``python -m repro_torch.examples.<name>``
on the CUDA device, or with ``--device cpu``.  Each ``main(argv)`` prints
the report of its JAX counterpart at the same default sizes and returns
what it printed, for callers that check it."""
