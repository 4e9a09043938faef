"""pytest settings of the benchmark's own tests (``benchmark/tests``):
the harness's modules on the path, and the ``card`` marker with its
fixture, which skips a test where no CUDA device is present."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(BENCH), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python3 -m pytest benchmark/tests -m card)")
    return torch.device("cuda", 0)
