"""Tests of the benchmark harness (``slambench/``): the CPU tests run the
harness on tiny throwaway cells with the port's plain versions; the card
tests (marked ``cuda``) skip without a card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
