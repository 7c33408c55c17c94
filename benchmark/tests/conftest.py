"""The benchmark's own tests: on the CPU at tiny sizes; those that need a
CUDA card are marked ``card`` and skip here, decided inside the test."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the card's kernels exist only there")
    return torch.device("cuda", 0)
