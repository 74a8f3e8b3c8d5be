"""Test settings of the benchmark's own tests: the ``needs_cuda`` marker
(registered by the repository's ``tests/conftest.py`` too) and a fixture
that decides at run time whether a card is there."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        'markers',
        'needs_cuda: runs only on a CUDA device (the test skips itself '
        'without one)')


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')
