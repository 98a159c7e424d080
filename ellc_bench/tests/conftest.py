"""The benchmark's CPU tests: ``python -m pytest ellc_bench/tests -q``.
Tests that need the card are marked ``cuda`` and skip inside a fixture
when none is present."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
