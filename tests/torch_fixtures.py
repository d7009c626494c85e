"""Fixtures and checks shared by the PyTorch port's test files
(`test_torch_*.py`)."""

import numpy as np
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


def edl_close(got, want):
    """EDL's tolerance: XLA-CPU's and torch's f32 `exp` differ by one ulp
    on some arguments (~9% of random ones, measured), and a channel
    truncated after `ch * shade` can then differ by 1.  Each channel
    within 1, on at most 0.1% of the pixels; prints the share found."""
    ne = got != want
    print(f"EDL: {ne.mean():.6f} of the pixels differ")
    assert ne.mean() <= 1e-3
    for sh in (0, 8, 16, 24):
        assert np.abs((got >> sh & 255).astype(int) - (want >> sh & 255)).max() <= 1
