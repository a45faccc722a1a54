"""Mixed-precision iterative refinement: f64 residuals, f32 inner solves
(torch port of ``effectivediffusivityfvm_tpu.solvers.refine``; solver name
``cgir``).

Extreme diffusivity contrasts (the shipped input.txt runs Dg = 1,237,500)
defeat fp32 Krylov solvers outright, and full f64 costs f64 bandwidth
everywhere.  Refinement keeps the hot loop in f32:

  x_64 in f64
  repeat:
    r_64 = b_64 - A_64 x_64                  (one f64 matvec per outer)
    if mean|r_64| / mean|b_64| < tol: stop
    r_hat = (r_64 / s)  cast to f32          (s = max|r_64|: O(1) RHS)
    solve  A_32' delta = r_hat'  in f32      (equilibrated inner CG)
    x_64 += s * delta_64

The outer loop runs on the host (one read of the relative residual an
outer); each inner solve is :func:`~.pcg.run_pcg` on the equilibrated f32
operator with the identity preconditioner, checks every 100 iterations on
the ``relresidual`` criterion.  Needs f64 inputs.
"""

from __future__ import annotations

import torch

from ..ops import fvm
from ..ops.flux import boundary_deff
from .driver import SolveResult
from .pcg import run_pcg

__all__ = ["solve_cgir", "solve_cgir_batched"]


def _mean_abs(a):
    return torch.mean(torch.abs(a), dim=(-2, -1))


def _refine(coeffs, spec, x0, *, tol, max_iter, inner_iters, inner_tol,
            batched):
    c32 = fvm.StencilCoeffs(*(a.to(torch.float32) for a in coeffs))
    c32_eq, s_eq = fvm.equilibrate(c32)
    bscale64 = _mean_abs(coeffs.b)

    def inner_solve(rhat32):
        # solve A' y = S rhat, delta = S y, from a zero initial guess
        res = run_pcg(
            matvec=lambda p: fvm.apply_operator(c32_eq, p),
            precond=lambda r, active=None: r,
            b=rhat32 * s_eq, x0=torch.zeros_like(rhat32),
            deff_fn=_mean_abs,                  # placeholder monitor (unused)
            tol=inner_tol, max_iter=inner_iters, check_every=100,
            criterion="relresidual", grid_ndim=2, batched=batched)
        return res.x * s_eq

    def rel_of(x):
        return _mean_abs(coeffs.b - fvm.apply_operator(coeffs, x)) / bscale64

    x = x0
    rel = rel_of(x0)
    outers = torch.zeros(rel.shape, dtype=torch.int32, device=x0.device)
    for _ in range(max_iter):
        active = rel > tol
        if not bool(active.any()):
            break
        r64 = coeffs.b - fvm.apply_operator(coeffs, x)
        scale = torch.amax(torch.abs(r64), dim=(-2, -1))
        safe = torch.where(scale > 0, scale, 1.0)[..., None, None]
        delta = inner_solve((r64 / safe).to(torch.float32)).to(torch.float64)
        # a converged image keeps its field (masked outer correction)
        x = torch.where(active[..., None, None], x + safe * delta, x)
        rel = torch.where(active, rel_of(x), rel)
        outers = outers + active.to(torch.int32)
    return SolveResult(x=x, deff=boundary_deff(spec, x), conv=rel,
                       iters=outers)


def _check_f64(x0, name):
    if x0.dtype != torch.float64:
        raise ValueError(f"{name} needs f64 inputs (set Dtype: float64)")


def solve_cgir(coeffs, spec, x0, *, omega: float = 0.0, tol: float = 1e-8,
               max_iter: int = 8, check_every: int = 0,
               criterion: str = "relresidual", inner_iters: int = 8_000,
               inner_tol: float = 1e-6) -> SolveResult:
    """Iteratively refined CG solve of one image (f64 in and out).
    ``max_iter`` counts outer refinement steps; ``tol`` is the outer
    relative residual.  ``omega``, ``check_every`` and ``criterion`` are
    signature parity (the outer criterion is always relresidual)."""
    _check_f64(x0, "solve_cgir")
    return _refine(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                   inner_iters=inner_iters, inner_tol=inner_tol,
                   batched=False)


def solve_cgir_batched(coeffs, spec, x0, *, omega: float = 0.0,
                       tol: float = 1e-8, max_iter: int = 8,
                       check_every: int = 0, criterion: str = "relresidual",
                       inner_iters: int = 8_000,
                       inner_tol: float = 1e-6) -> SolveResult:
    """Batched refinement on ``(B, ny, nx)``: the stack shares each outer
    step (one f64 matvec, one batched f32 inner PCG with per-image
    freezing); converged images stop updating."""
    _check_f64(x0, "solve_cgir_batched")
    return _refine(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                   inner_iters=inner_iters, inner_tol=inner_tol,
                   batched=True)
