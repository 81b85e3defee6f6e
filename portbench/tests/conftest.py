"""pytest settings of the benchmark's tests: the ``card`` marker, and the
``card`` fixture that skips a test when this machine has no CUDA card.

Run them from the root of the repository:

    python -m pytest portbench/tests -q

The card is looked for inside the fixture, when a test runs, never while a
module is imported, so every worker collects the same tests.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's widths there")
    return "cuda"
