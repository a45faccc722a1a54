"""Weighted-Jacobi solve drivers on the plain PyTorch sweep (torch port of
``effectivediffusivityfvm_tpu.solvers.jacobi``).

The sweep is the reference's hot kernel ``updateX_SOR`` (Deff2D.cuh:69-92 —
weighted Jacobi despite the name) as whole-tensor arithmetic,
:func:`~..ops.fvm.jacobi_sweep` with the full five-point stencil; the JAX
package also computes it outside any Pallas kernel.  The stopping rules are
the reference's (:mod:`.driver`).  ``Solver: jacobi_pallas``
(:mod:`.jacobi_pallas`) runs the same schedule on the K3 kernel.
"""

from __future__ import annotations

import torch

from ..ops import fvm
from ..ops.flux import BoundaryFluxSpec
from . import driver
from .driver import SolveResult

__all__ = ["SolveResult", "solve_jacobi", "solve_jacobi_batched"]


def _sweeps(coeffs: fvm.StencilCoeffs, omega: float):
    def run(x: torch.Tensor, k: int, active=None) -> torch.Tensor:
        y = x
        for _ in range(k):
            y = fvm.jacobi_sweep(coeffs, y, omega)
        if active is None:
            return y
        keep = active.reshape(active.shape + (1,) * (x.dim() - 1))
        return torch.where(keep, y, x)
    return run


def solve_jacobi(
    coeffs: fvm.StencilCoeffs,
    spec: BoundaryFluxSpec,
    x0: torch.Tensor,
    *,
    omega: float = 2.0 / 3.0,
    tol: float = 1e-5,
    max_iter: int = 500_000,
    check_every: int = 0,
    criterion: str = "deff",
    it0: int = 0,
    deff0: float = 1.0,
    deff_old0: float = 5.0,
) -> SolveResult:
    """Solve one ``(ny, nx)`` image to the reference stopping rule.

    ``it0``/``deff0``/``deff_old0``: protocol carry for segmented solves
    (see :func:`.driver.run_single`); the defaults are the reference's
    fresh start (Deff2D.cuh:1171-1173)."""
    omega = omega or 2.0 / 3.0
    return driver.run_single(
        _sweeps(coeffs, omega), coeffs, spec, x0, tol=tol, max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion, it0=it0, deff0=deff0, deff_old0=deff_old0)


def solve_jacobi_batched(
    coeffs: fvm.StencilCoeffs,       # tensors (B, ny, nx)
    spec: BoundaryFluxSpec,          # tensors (B, ny)
    x0: torch.Tensor,                # (B, ny, nx)
    *,
    omega: float = 2.0 / 3.0,
    tol: float = 1e-5,
    max_iter: int = 500_000,
    check_every: int = 0,
    criterion: str = "deff",
    it0: int = 0,
    deff0: float = 1.0,
    deff_old0: float = 5.0,
) -> SolveResult:
    """Batched solve with per-image convergence (the ML-datagen mode): the
    whole batch advances together and each image freezes at exactly the
    sweep count where the serial reference would have stopped it."""
    omega = omega or 2.0 / 3.0
    return driver.run_batched(
        _sweeps(coeffs, omega), coeffs, spec, x0, tol=tol, max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion, it0=it0, deff0=deff0, deff_old0=deff_old0)
