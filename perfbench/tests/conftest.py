"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the root of the checkout. Those marked ``card`` need a CUDA card and skip
without one; on the card they run with the rest."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """cuda:0, or a skip where there is no card (decided when the test
    runs, never when a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
