"""Settings of the benchmark's own tests: ``python -m pytest
portbench/tests``.

Tests marked ``card`` need an NVIDIA GPU; each decides inside the test,
through the ``card`` fixture, and skips with a reason where there is none.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False here")
    return "cuda:0"


@pytest.fixture(scope="session")
def tiny_bench():
    """The test cell ``tiny``: DenseNet at 64 px patches on a 256 x 192
    slide (``tests/data``)."""
    return Path(__file__).resolve().parent / "data" / "BENCHMARK.json"
