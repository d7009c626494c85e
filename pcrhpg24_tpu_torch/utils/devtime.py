"""Device time of a call on the card, from CUDA events.

Counterpart of `pcrhpg24_tpu/utils/devtime.py:device_ms`, which reads
the device's own time from a `jax.profiler` trace.  Here two CUDA
events bracket the calls, as `tools/profile_frame.py` and the renderer's
`frame_ms` do, and the calls are enqueued behind a device spin of about
a millisecond, so the card is still busy while the host enqueues them
and the events bracket device work alone, not the host's (as long as
the calls neither wait for the card nor take the host longer than the
spin).
The reference's `trace_jit_ms` reads XLA traces and has no counterpart.
"""

from __future__ import annotations

import torch

SPIN_CYCLES = 2_000_000  # ~1 ms of device spin at an H100's clock


def device_ms(fn, *args, reps: int = 1) -> float:
    """Device ms of `reps` calls of `fn(*args)` (the total: the caller
    divides), after one warm call.  Needs a card: raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    for _ in range(reps):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)
