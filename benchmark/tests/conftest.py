"""Tests of the benchmark harness, run on the CPU:

    python -m pytest benchmark/tests -q

Tests marked ``card`` need an NVIDIA card and skip elsewhere; the decision is
made inside a fixture, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
