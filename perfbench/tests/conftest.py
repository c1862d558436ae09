"""The benchmark's own tests (``python -m pytest perfbench/tests``): CPU
tests at tiny sizes, and tests marked ``card`` that run only where a CUDA
device is present (decided inside the fixture, never at import)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(HERE, "tests"), HERE, os.path.dirname(HERE)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest perfbench/tests -m card)")
    return "cuda"
