"""CPU tests of the benchmark harness (``python -m pytest portbench/tests``).

They import neither JAX nor the JAX package. A test that needs a card
takes the ``card`` fixture, which skips it where there is none (decided
inside the fixture, never at import).
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
