"""Metric readers, one module a metric, named as the metric in
``BENCHMARK.json`` (end-to-end and per-layer alike).  Each has
``read(record) -> float | None``: ``None`` when the run's record holds
nothing for it to read, and the harness then leaves the metric out of the
result line.

The record (``harness/cell.py``) holds the window's end-to-end arithmetic
``e2e`` (``harness/stats.py``), ``setup_s`` and the device's
``peak_bytes``; the window's ``answers`` (what each said, with its rounds
and whether the synopsis answered it at admission); and, in a traced run,
the program's ``spans`` that started in the window (name, start, seconds,
args), the ``profile`` of a stretch of rounds under ``torch.profiler``
(wall and device-busy seconds, device seconds and launches by operation,
idle gaps by program span, each round's (B, mode) from the program's
``kernel`` span), the ``aten`` count over a stretch of rounds, the
round's ``shape`` (workers, columns, slots, synopsis cache rows,
residency) and the card's ``kind``.
"""
