"""Tests of the benchmark harness. Run from the checkout's root:

    python -m pytest portbench/tests -q

Tests that need the card carry the `cuda` marker and skip without one;
the fixture `cuda` decides, never at import time."""

import sys
from pathlib import Path

import pytest
import torch

BASE = Path(__file__).resolve().parents[1]
for p in (str(BASE), str(BASE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """The harness's CPU runs are tiny; many threads only contend."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
