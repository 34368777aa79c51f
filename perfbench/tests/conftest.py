"""Test settings of the benchmark's own tests.

    PYTHONPATH=src python -m pytest -q perfbench/tests

The repository's test run (``tests/``) does not collect these.  Tests
marked ``card`` need a CUDA card and skip without one; the rest run on the
CPU at small sizes.
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
