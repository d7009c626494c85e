"""PyTorch + CUDA (Hopper) port of `pcrhpg24_tpu`.

The JAX package beside this one is the reference: every module here
mirrors the reference module of the same path and is held bit-exact
against it by `tests/test_torch_*.py`.  This package imports `torch`
and never `jax`, and nothing of `pcrhpg24_tpu`: what it needs of the
reference's jax-free modules (`constants`, `codec`, `formats`, `native`,
`preprocess`, `render.camera`'s host half, `engine.debug`,
`engine.method`, `engine.timing`, `utils`) it keeps as its own copy
under the same relative path.

Every Pallas kernel on the ported path has a hand-written CUDA kernel
for sm_90a under `csrc/`, built at first use by `kernels/build.py`, and
a plain PyTorch version in the same module.  A wrapper runs the plain
version for CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch


def device_of(device) -> torch.device:
    """`device` as a torch.device; raises if it names an absent card.

    Entry points call this so that `device="cuda"` on a host without a
    card fails up front instead of carrying on somewhere else.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available on this host")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
