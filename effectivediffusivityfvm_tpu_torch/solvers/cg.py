"""Jacobi-preconditioned conjugate gradients (BASELINE config 3; torch port
of ``effectivediffusivityfvm_tpu.solvers.cg``).

Matrix-free PCG on the structured 5-point operator: the matvec is
:func:`~..ops.fvm.apply_operator`, the preconditioner the reciprocal
diagonal carried in :class:`~..ops.fvm.StencilCoeffs`, the dot products
device reductions; the loop and its stopping rules are :mod:`.pcg`'s.
The JAX package computes all of it in XLA, outside any Pallas kernel, so
this is plain PyTorch on the card as well.

CG needs symmetry: 3-phase masked systems must be assembled with
``fvm_coefficients(..., symmetric=True)``.
"""

from __future__ import annotations

from ..ops import fvm
from ..ops.flux import boundary_deff
from .driver import SolveResult, resolve_check_every
from .pcg import run_pcg

__all__ = ["solve_cg", "solve_cg_batched"]


def _run(coeffs, spec, x0, batched, *, tol, max_iter, check_every,
         criterion):
    return run_pcg(
        matvec=lambda p: fvm.apply_operator(coeffs, p),
        precond=lambda r, active=None: coeffs.diag_inv * r,
        b=coeffs.b,
        x0=x0,
        deff_fn=lambda x: boundary_deff(spec, x),
        tol=tol, max_iter=max_iter,
        check_every=resolve_check_every(check_every, 100),
        criterion=criterion, grid_ndim=2, batched=batched,
    )


def solve_cg(coeffs, spec, x0, *, omega: float = 0.0, tol: float = 1e-8,
             max_iter: int = 100_000, check_every: int = 0,
             criterion: str = "residual") -> SolveResult:
    """PCG solve of one ``(ny, nx)`` image.  ``omega`` is accepted for
    signature parity with the sweep solvers and ignored."""
    return _run(coeffs, spec, x0, False, tol=tol, max_iter=max_iter,
                check_every=check_every, criterion=criterion)


def solve_cg_batched(coeffs, spec, x0, *, omega: float = 0.0,
                     tol: float = 1e-8, max_iter: int = 100_000,
                     check_every: int = 0,
                     criterion: str = "residual") -> SolveResult:
    """Batched PCG on ``(B, ny, nx)`` with per-image freezing."""
    return _run(coeffs, spec, x0, True, tol=tol, max_iter=max_iter,
                check_every=check_every, criterion=criterion)
