import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips with the reason without one")


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided here, never while a
    module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
