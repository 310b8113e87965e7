"""The port's parity suite on the card: the counterpart of ``tests_tpu/``.

Run on a machine with an NVIDIA GPU, from the repository root::

    python -m pytest tests_gpu -q

Every test is skipped where ``torch.cuda.is_available()`` is false (the
decision is made in a fixture, when a test runs, so every worker collects
the same tests).  Nothing here imports JAX: the references on the card are
the port's plain versions, its CPU path and scipy.  The checks that are new
to the card are functions of ``chip_smoke.py`` (phases 26-27), which the
tests call, so that every run of that script gates them too.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _needs_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("tests_gpu needs a CUDA device (torch.cuda.is_available() is false)")
