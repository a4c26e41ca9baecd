"""OLA-RAW on PyTorch and CUDA: the workload server's shared-scan round.

A second package beside the JAX reference ``repro``; its modules mirror
``repro``'s layout and names (``repro_torch/core/engine.py`` is the
counterpart of ``repro/core/engine.py``, and so on).  It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``.

Entry points (``SlotOLAEngine``, ``OLAEngine``, ``EstimationController``,
``OLAWorkloadServer``) run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise rather than quietly
running on the CPU.  The round's EXTRACT is a hand-written CUDA kernel
(``csrc/slot_extract.cu``; ``csrc/slot_extract_grouped.cu`` when the
engine serves GROUP BY; the slab kernels under streaming residency) for
CUDA tensors and its plain PyTorch version (``kernels/ref.py``) for CPU
tensors.
"""
