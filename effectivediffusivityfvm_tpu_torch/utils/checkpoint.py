"""Solver-state checkpoint/resume (torch port of
``effectivediffusivityfvm_tpu.utils.checkpoint``).

The reference lacks this ("if the code is interrupted, all progress is
lost", documentation PDF §3.6).  Two layers:

  * batch-level resume -- ``io.writers.IncrementalBatchWriter`` makes an
    interrupted datagen batch restartable from the last finished image;
  * solve-level checkpoints -- this module saves and loads the
    concentration field(s) and progress counters as a compressed ``.npz``
    (keys ``x``, ``iters`` and ``meta_*``, the JAX package's layout, so a
    file written by either package loads in the other), and runs a solve
    in segments of ``segment_iters`` with a checkpoint after each.

The JAX package's orbax backend is not ported (the ROADMAP's "Do not
port"): ``backend="orbax"`` and orbax checkpoint directories raise
``NotImplementedError``.  :class:`AsyncSaver` takes the place of its
``AsyncOrbaxSaver`` over the same npz files.
"""

from __future__ import annotations

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save_state", "load_state", "checkpointed_solve", "AsyncSaver"]

_NO_ORBAX = ("orbax checkpoints are not ported to the torch package "
             "(ROADMAP, 'Do not port'); use the npz backend")


def _host(a, copy: bool = False) -> np.ndarray:
    """``a`` as a numpy array on the host (a private copy if ``copy``)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=copy).numpy()
    return np.array(a, copy=True) if copy else np.asarray(a)


def _payload(x, iters, meta, copy: bool = False) -> Dict[str, np.ndarray]:
    payload = {"x": _host(x, copy), "iters": np.asarray(iters)}
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = _host(v, copy)
    return payload


def _write_npz(path: str, payload: Dict[str, np.ndarray]) -> None:
    """Write ``payload`` to ``path`` atomically (a temporary file in the
    same directory, then ``os.replace``)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_state(path: str, x, iters=0, meta: Optional[Dict[str, Any]] = None,
               backend: str = "npz") -> None:
    """Atomically write a solve checkpoint (field + progress) as one
    compressed ``.npz``; CUDA tensors are copied to the host first."""
    if backend == "orbax":
        raise NotImplementedError(_NO_ORBAX)
    _write_npz(path, _payload(x, iters, meta))


def load_state(path: str):
    """Returns ``(x, iters, meta)`` (numpy) or None if no checkpoint
    exists."""
    if os.path.isdir(path):
        raise NotImplementedError(_NO_ORBAX)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        x = z["x"]
        iters = int(z["iters"])
        meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return x, iters, meta


def _scalar(a) -> float:
    return float(np.max(_host(a)))


def checkpointed_solve(solve_fn, coeffs, spec, x0, *, checkpoint_path: str,
                       segment_iters: int, max_iter: int,
                       protocol_carry: bool = False, **solve_kw):
    """Run ``solve_fn`` in segments of ``segment_iters``, checkpointing the
    field after each segment; resumes from an existing checkpoint.

    ``solve_fn`` is any solver of the package (same signature family).
    Returns the final ``SolveResult`` with ``iters`` counting all segments
    (previously checkpointed ones included); the field keeps ``x0``'s
    dtype and device.

    ``protocol_carry=True`` (sweep solvers with ``criterion="deff"`` only)
    threads the reference stopping protocol across segments: the global
    sweep count and the deff/deff_old monitor state are carried
    (``solvers.driver.run_single``), so the segmented run stops at exactly
    the sweep where one continuous run would.  Requires ``segment_iters >=
    check_every`` so every segment lands on a check.
    """
    from ..solvers.driver import SolveResult

    done = 0
    carry = {}
    state = load_state(checkpoint_path)
    if state is not None:
        x_saved, done, meta = state
        x0 = torch.as_tensor(x_saved, dtype=x0.dtype, device=x0.device)
        if protocol_carry and "deff" in meta:
            carry = {"deff0": float(meta["deff"]),
                     "deff_old0": float(meta["deff_old"])}
        if meta.get("converged") or (done >= max_iter and "deff" in meta):
            # the checkpoint IS the finished solve; re-running sweeps from a
            # converged field would shift the protocol Deff
            def scal(v, dtype=x0.dtype):
                return torch.tensor(v, dtype=dtype, device=x0.device)

            return SolveResult(
                x=x0, deff=scal(float(meta.get("deff", np.nan))),
                conv=scal(float(meta.get("conv", np.nan))),
                iters=scal(done, torch.int32))

    res = None
    while done < max_iter:
        seg = min(segment_iters, max_iter - done)
        kw = dict(solve_kw)
        if protocol_carry:
            kw.update(it0=done, **carry)
        res = solve_fn(coeffs, spec, x0, max_iter=seg, **kw)
        seg_iters = int(np.max(_host(res.iters)))
        total = done + seg_iters
        converged = seg_iters < seg
        # at any check the reference sets deff_old = deff = deff_new
        # (Deff2D.cuh:1263-1275); segments end on checks, so both carry the
        # same value
        d = _scalar(res.deff)
        if protocol_carry:
            carry = {"deff0": d, "deff_old0": d}
        meta = {"deff": d, "deff_old": d, "conv": _scalar(res.conv),
                "converged": int(converged)}
        save_state(checkpoint_path, res.x, total, meta=meta)
        x0 = res.x
        # converged before exhausting the segment -> stop
        if converged:
            done = total
            break
        done += seg

    if res is not None:
        res = res._replace(iters=torch.tensor(done, dtype=torch.int32,
                                              device=res.x.device))
    return res


class AsyncSaver:
    """Checkpoint writes that overlap the next solve segment (the port of
    the JAX package's ``AsyncOrbaxSaver``, over :func:`save_state`'s npz).

    ``save`` returns once the field is on the host; one worker thread
    compresses and writes the file while the caller goes on.  Use it as a
    context manager so the last write is awaited::

        with AsyncSaver() as saver:
            for segment in ...:
                res = solve(...)
                saver.save(path, res.x, iters=total, meta=...)

    ``wait()`` waits for every pending write and raises the first error
    one of them met.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def save(self, path: str, x, iters=0,
             meta: Optional[Dict[str, Any]] = None) -> None:
        payload = _payload(x, iters, meta, copy=True)
        self._pending.append(self._pool.submit(_write_npz, path, payload))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.wait()
        finally:
            self._pool.shutdown()
