"""Tests of the benchmark itself (``python -m pytest bench/tests``).

The repository's own suite (``tests/``) does not collect these.  Tests
that need the card carry the ``chip`` marker and skip inside the ``cuda``
fixture when there is none, so that every worker collects the same tests.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    """Register the marker of tests that run only on the card."""
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda():
    """The card, or a skip when this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cells' "
                    "own sizes on the chip")
    return torch.device("cuda")
