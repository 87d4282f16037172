"""The benchmark's own tests: ``python -m pytest kpwbench/tests``.  They run
on the CPU through ``encoder_backend("cuda", device="cpu")``; those marked
``cuda`` need a card and skip elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
