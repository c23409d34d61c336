"""The benchmark's own tests: run from the repository's root with
``python -m pytest benchmark/tests``; those marked ``cuda`` need a card and
skip without one (run them on the card: ``python3 -m pytest -m cuda
benchmark/tests``)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs in TF32, which only a card has")
    return torch.device("cuda", 0)
