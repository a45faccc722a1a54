"""Jacobi solver on the K3 kernel (torch port of
``effectivediffusivityfvm_tpu.solvers.jacobi_pallas``).

The module and solver name are the JAX package's, so ``Solver:
jacobi_pallas`` in an existing ``input.txt`` selects it; here the sweeps run
as K3, the hand-written CUDA kernel of :mod:`..ops.kernels.jacobi` (its
plain PyTorch version on a CPU tensor).  The stopping rules are the
reference's (:mod:`.driver`): a 1-sweep opening window, then windows of
``check_every`` sweeps, each issued as one :func:`jacobi_sweeps` call with
the converged images frozen; ``iters`` counts the sweeps of active images
only.

K3 reads only ``a_w``/``a_n`` of the stencil, so masked (3-phase) systems
must come from the symmetric assembly (``dispatch.needs_spd``).  The JAX
package's VMEM size guard and its fallback to the plain sweep are a TPU
budget and have no counterpart: K3 takes every grid size.
"""

from __future__ import annotations

from ..ops import fvm
from ..ops.flux import BoundaryFluxSpec
from ..ops.kernels.jacobi import jacobi_sweeps
from . import driver
from .driver import SolveResult

__all__ = ["solve_jacobi_pallas", "solve_jacobi_pallas_batched"]


def solve_jacobi_pallas(coeffs: fvm.StencilCoeffs, spec: BoundaryFluxSpec,
                        x0, *, omega: float = 2.0 / 3.0, tol: float = 1e-5,
                        max_iter: int = 500_000, check_every: int = 0,
                        criterion: str = "deff") -> SolveResult:
    """One ``(ny, nx)`` image, solved as a batch of one."""
    res = solve_jacobi_pallas_batched(
        fvm.StencilCoeffs(*(a[None] for a in coeffs)),
        BoundaryFluxSpec(*(a[None] for a in spec)), x0[None],
        omega=omega, tol=tol, max_iter=max_iter, check_every=check_every,
        criterion=criterion)
    return SolveResult(*(a[0] for a in res))


def solve_jacobi_pallas_batched(coeffs: fvm.StencilCoeffs,
                                spec: BoundaryFluxSpec, x0, *,
                                omega: float = 2.0 / 3.0, tol: float = 1e-5,
                                max_iter: int = 500_000, check_every: int = 0,
                                criterion: str = "deff") -> SolveResult:
    """A ``(B, ny, nx)`` batch with per-image freezing."""
    omega = omega or 2.0 / 3.0

    def sweeps(x, k, active):
        return jacobi_sweeps(coeffs, x, k, omega=omega, active=active)

    return driver.run_batched(
        sweeps, coeffs, spec, x0.contiguous(), tol=tol, max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion)
