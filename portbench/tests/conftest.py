"""The `card` marker: a test that needs an NVIDIA card decides inside
itself, through the `card` fixture, whether one is present, and skips
with its reason where none is."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda")
