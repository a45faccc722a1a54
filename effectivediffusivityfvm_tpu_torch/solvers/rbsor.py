"""Red-black SOR solver (BASELINE config 2; torch port of
``effectivediffusivityfvm_tpu.solvers.rbsor``).

True successive over-relaxation as two-colour Gauss-Seidel: cells are
coloured by ``(i+j)`` parity; the red half-sweep uses the current black
values, the black half-sweep the fresh reds.  Each half-sweep computes a
full-grid Jacobi-style update and keeps its colour, as the JAX package
does in XLA (it has no Pallas kernel).  :func:`omega_opt` estimates the
optimal relaxation from the Jacobi spectral radius of the Laplace problem
on the grid.  The stopping rules are :mod:`.driver`'s; ``sweeps(x, k)``
runs ``k`` sweeps a window with the colour mask built once per solve (on
the card as a CUDA graph of one sweep, replayed).
"""

from __future__ import annotations

import math

import torch

from ..ops import fvm
from . import driver
from .driver import SolveResult

__all__ = ["solve_rbsor", "solve_rbsor_batched", "rb_sweep", "omega_opt"]


def omega_opt(ny: int, nx: int) -> float:
    """SOR-optimal relaxation for the Laplace model problem on (ny, nx):
    ``2 / (1 + sqrt(1 - rho_J^2))`` with ``rho_J = cos(pi/n)``, n the larger
    grid dimension."""
    rho = math.cos(math.pi / max(ny, nx, 2))
    return 2.0 / (1.0 + math.sqrt(1.0 - rho * rho))


def red_mask(shape, device) -> torch.Tensor:
    """``True`` on the red cells, ``(i + j)`` even, of the trailing dims of
    ``shape`` (2D or 3D: the parity of the index sum)."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    for ax, n in enumerate(shape):
        view = [1] * len(shape)
        view[ax] = n
        idx = idx + torch.arange(n, device=device).reshape(view)
    return idx % 2 == 0


def _half(coeffs, nbsum, x, mask, omega):
    gs = (coeffs.b + nbsum(coeffs, x)) * coeffs.diag_inv
    return torch.where(mask, x + omega * (gs - x), x)


def rb_sweep(coeffs: fvm.StencilCoeffs, x: torch.Tensor, omega: float,
             red=None, nbsum=fvm.neighbor_sum) -> torch.Tensor:
    """One full red-black SOR sweep (red half, then black).  ``red``: the
    colour mask (:func:`red_mask`, built here if not given); ``nbsum``: the
    neighbour sum (the 3D solvers pass theirs)."""
    if red is None:
        red = red_mask(x.shape[-2:], x.device)
    x = _half(coeffs, nbsum, x, red, omega)
    return _half(coeffs, nbsum, x, ~red, omega)


class _GraphedSweep:
    """``sweep`` captured once as a CUDA graph and replayed ``k`` times a
    window: a red-black sweep is ~40 small launches, which cost the host
    more than the card (PyTorch's own graph API; the same kernels on the
    same data, so the same numbers)."""

    def __init__(self, sweep, like: torch.Tensor):
        self.static = like.clone()
        side = torch.cuda.Stream(like.device)
        side.wait_stream(torch.cuda.current_stream(like.device))
        with torch.cuda.stream(side):
            sweep(self.static)                  # warm up outside the capture
        torch.cuda.current_stream(like.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static.copy_(sweep(self.static))

    def __call__(self, x: torch.Tensor, k: int) -> torch.Tensor:
        self.static.copy_(x)
        for _ in range(k):
            self.graph.replay()
        return self.static.clone()


def sweeps_fn(coeffs, omega: float, grid_ndim: int = 2,
              nbsum=fvm.neighbor_sum):
    """``run(x, k, active=None)``: ``k`` red-black sweeps, images whose
    ``active`` flag is False left as they were.  On a CUDA tensor the sweep
    runs as a CUDA graph, captured on the first window."""
    red = red_mask(coeffs.b.shape[-grid_ndim:], coeffs.b.device)
    graphed = []

    def sweep(x):
        return rb_sweep(coeffs, x, omega, red, nbsum)

    def run(x: torch.Tensor, k: int, active=None) -> torch.Tensor:
        if x.is_cuda:
            if not graphed:
                graphed.append(_GraphedSweep(sweep, x))
            y = graphed[0](x, k)
        else:
            y = x
            for _ in range(k):
                y = sweep(y)
        if active is None:
            return y
        keep = active.reshape(active.shape + (1,) * grid_ndim)
        return torch.where(keep, y, x)
    return run


def solve_rbsor(
    coeffs: fvm.StencilCoeffs,
    spec,
    x0: torch.Tensor,
    *,
    omega: float = 0.0,          # 0 or None -> auto (omega_opt of the grid)
    tol: float = 1e-5,
    max_iter: int = 500_000,
    check_every: int = 0,
    criterion: str = "deff",
) -> SolveResult:
    """Red-black SOR on one ``(ny, nx)`` image to the reference stopping
    rule (:func:`.driver.run_single`)."""
    if not omega:
        omega = omega_opt(x0.shape[-2], x0.shape[-1])
    return driver.run_single(
        sweeps_fn(coeffs, omega), coeffs, spec, x0, tol=tol,
        max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion)


def solve_rbsor_batched(
    coeffs: fvm.StencilCoeffs,
    spec,
    x0: torch.Tensor,
    *,
    omega: float = 0.0,
    tol: float = 1e-5,
    max_iter: int = 500_000,
    check_every: int = 0,
    criterion: str = "deff",
) -> SolveResult:
    """Batched :func:`solve_rbsor` on ``(B, ny, nx)`` with per-image
    freezing."""
    if not omega:
        omega = omega_opt(x0.shape[-2], x0.shape[-1])
    return driver.run_batched(
        sweeps_fn(coeffs, omega), coeffs, spec, x0, tol=tol,
        max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion)
