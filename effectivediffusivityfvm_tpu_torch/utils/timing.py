"""Wall-clock timing of device work (torch port of
``effectivediffusivityfvm_tpu.utils.timing``).

The reference times its solve loop with a ``cudaEvent_t`` pair
(Deff2D.cuh:1226-1230, 1294-1298).  PyTorch's CUDA work is asynchronous, so
a timed region ends with ``torch.cuda.synchronize()`` when the outputs lie on
a CUDA device.  Feeds the ``Time`` CSV column (seconds; the reference stores
milliseconds and divides by 1000 at write time, Deff2D.cuh:184).
"""

from __future__ import annotations

import time

import torch

__all__ = ["time_fn"]


def _cuda_devices(out) -> set:
    if isinstance(out, torch.Tensor):
        return {out.device} if out.device.type == "cuda" else set()
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(o) for o in out))
    return set()


def time_fn(fn, *args, **kwargs):
    """Run ``fn``, wait for its outputs' devices, return ``(result, seconds)``."""
    start = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - start
