"""The benchmark's own tests, on the CPU (``python -m pytest
benchmark/tests``). A test that needs the card takes the ``card``
fixture, which skips where there is none; it is decided inside the
fixture, never while a module is imported."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and its toolchain (nvcc)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture
def mini_root(tmp_path):
    from benchmark.tests import mini
    return mini.make_root(tmp_path)
