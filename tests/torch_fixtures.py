"""Fixtures and checks shared by the PyTorch port's test files
(`test_torch_*.py`)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes on one host's cores: one torch
    thread each keeps them from oversubscribing it (with a pool per
    process the small ops of the plain paths slow down some 30x).
    Import it into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

