"""Profiling and observability (torch port of
``effectivediffusivityfvm_tpu.utils.profiling``).

The reference's only instrumentation is a cudaEvent wall time of the solve
loop (Deff2D.cuh:1226-1230).  Here:

  * :func:`trace` wraps a region in ``torch.profiler`` (CPU and, where a
    card is present, CUDA activity) and writes a Chrome trace into a
    directory, which TensorBoard, Perfetto or ``chrome://tracing`` open:
    the kernels by name with their device times;
  * :func:`benchmark_solver` measures the steady-state time of any solver
    call, its iterations and an effective memory rate;
  * :class:`RunManifest` accumulates per-run metadata (config, timings,
    convergence) and writes a JSON manifest next to the CSV outputs.

Timing always waits for the device: a CUDA result is synchronized before
the clock stops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["trace", "benchmark_solver", "RunManifest"]


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("deff-trace") as prof: run()`` -> a
    ``*.pt.trace.json`` Chrome trace in ``log_dir``; ``prof`` is the
    ``torch.profiler.profile`` (``prof.key_averages()``, ...)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


def _wait(res) -> None:
    """Block until the solve behind ``res`` (a ``SolveResult`` or a tuple
    led by the field) has finished on its device."""
    x = res[0] if isinstance(res, tuple) else res.x
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def benchmark_solver(solve_fn: Callable, *args, repeats: int = 3,
                     bytes_per_iter: Optional[float] = None,
                     **kwargs) -> Dict[str, Any]:
    """Warm up once, then time ``solve_fn(*args, **kwargs)``.

    Returns a dict with wall seconds (best of ``repeats``), the times,
    iterations (if the result carries ``.iters``; summed over a batch) and
    effective GB/s when ``bytes_per_iter`` is given (memory traffic an
    iteration x iterations / time).
    """
    _wait(solve_fn(*args, **kwargs))

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = solve_fn(*args, **kwargs)
        _wait(res)
        times.append(time.perf_counter() - t0)
    best = min(times)
    out: Dict[str, Any] = {"seconds": best, "times": times}
    iters = getattr(res, "iters", None)
    if iters is not None:
        total_iters = int(torch.as_tensor(iters).sum())
        out["iterations"] = total_iters
        if bytes_per_iter:
            out["effective_gbps"] = total_iters * bytes_per_iter / best / 1e9
    return out


@dataclasses.dataclass
class RunManifest:
    """JSON run manifest accumulated alongside CSV outputs."""

    path: str
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    records: list = dataclasses.field(default_factory=list)

    def set_config(self, cfg) -> None:
        self.meta["config"] = {
            k: v for k, v in dataclasses.asdict(cfg).items()
            if isinstance(v, (int, float, str, bool))
        }

    def add(self, **record) -> None:
        self.records.append(record)

    def write(self) -> None:
        with open(self.path, "w") as fh:
            json.dump({"meta": self.meta, "records": self.records}, fh,
                      indent=2)
