"""The benchmark's tests: ``python -m pytest olabench/tests`` from the
checkout's root, on the CPU; the tests marked ``cuda`` need a card and skip
without one (``-m cuda`` runs them alone on the card)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA device; skips the test on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
