"""The upstream solver's protocol in plain PyTorch (EffectiveDiffusivityFVM,
``JacobiGPU``): damped Jacobi from the linear start, Deff checked after the
first sweep and then every ``check_every`` sweeps, stopping at the first
check whose relative Deff change ``(old - new) / old`` is within ``tol`` in
magnitude, or once ``max_iter`` sweeps have run (the Deff of the last check
stands; the old Deff starts at 5).

The images of a batch run together; an image keeps sweeping after its stop,
but its Deff and sweep count are taken at the stop.  On a CUDA device a
chunk of sweeps is captured once as a CUDA graph and replayed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fvm2d

CHUNK = 500          # sweeps a graph replay runs on the card


class _Sweeper:
    """Damped-Jacobi sweeps on zero-bordered ping-pong buffers."""

    def __init__(self, s: fvm2d.System, x0: torch.Tensor, omega: float):
        pad = (1, 1, 1, 1)
        self.buf = [torch.nn.functional.pad(x0, pad),
                    torch.zeros_like(torch.nn.functional.pad(x0, pad))]
        self.s = s
        self.keep = 1.0 - omega
        self.scale = omega / s.diag
        self.tmp = torch.empty_like(x0)
        self.cur = 0
        self.graph = None
        if x0.is_cuda:
            self._capture()

    def _sweep(self, src, dst):
        s, t = self.s, self.tmp
        torch.mul(s.a_w, src[..., 1:-1, :-2], out=t)
        t.addcmul_(s.a_e, src[..., 1:-1, 2:])
        t.addcmul_(s.a_n, src[..., :-2, 1:-1])
        t.addcmul_(s.a_s, src[..., 2:, 1:-1])
        t.add_(s.b)
        t.mul_(self.scale)
        dst[..., 1:-1, 1:-1] = t.add_(src[..., 1:-1, 1:-1], alpha=self.keep)

    def _pair(self):
        self._sweep(self.buf[0], self.buf[1])
        self._sweep(self.buf[1], self.buf[0])

    def _capture(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        saved = self.buf[0].clone()
        with torch.cuda.stream(side):
            self._pair()                         # warm the allocator
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(CHUNK // 2):
                self._pair()
        self.buf[0].copy_(saved)

    def run(self, k: int):
        """``k`` more sweeps."""
        if self.cur == 1 and k:
            self._sweep(self.buf[1], self.buf[0])
            self.cur, k = 0, k - 1
        if self.graph is not None:
            while k >= CHUNK:
                self.graph.replay()
                k -= CHUNK
        while k >= 2:
            self._pair()
            k -= 2
        if k:
            self._sweep(self.buf[0], self.buf[1])
            self.cur = 1

    @property
    def x(self):
        return self.buf[self.cur][..., 1:-1, 1:-1]


def solve(d: torch.Tensor, *, c_left: float, c_right: float, omega: float,
          tol: float, max_iter: int, check_every: int):
    """Run the protocol on the ``(B, ny, nx)`` diffusivity field ``d`` in its
    dtype.  Returns ``(deff, sweeps)`` as numpy arrays."""
    s = fvm2d.system(d, c_left, c_right)
    x0 = fvm2d.linear_start(d.shape, c_left, c_right, d.dtype, d.device)
    sw = _Sweeper(s, x0, omega)
    bsz = d.shape[0]
    deff = np.ones(bsz)
    deff_old = np.full(bsz, 5.0)
    sweeps = np.zeros(bsz, np.int64)
    live = np.ones(bsz, bool)
    it = 0
    while it < max_iter and live.any():
        k = min(check_every - ((it - 1) % check_every), max_iter - it)
        it += k
        sweeps[live] = it
        if (it - 1) % check_every:
            break              # cut by max_iter: no check, no need to sweep
        sw.run(k)
        new = fvm2d.deff(d, sw.x, c_left, c_right).double().cpu().numpy()
        change = (deff_old - new) / deff_old
        deff = np.where(live, new, deff)
        deff_old = np.where(live, new, deff_old)
        live &= ~(np.abs(change) <= tol)
    return deff, sweeps


def relax(d: torch.Tensor, *, c_left: float, c_right: float, omega: float,
          sweeps: int) -> torch.Tensor:
    """``sweeps`` damped-Jacobi sweeps from the linear start on the
    ``(B, ny, nx)`` field ``d``, in its dtype; returns the field ``x``."""
    s = fvm2d.system(d, c_left, c_right)
    sw = _Sweeper(s, fvm2d.linear_start(d.shape, c_left, c_right, d.dtype,
                                        d.device), omega)
    sw.run(sweeps)
    return sw.x.clone()
