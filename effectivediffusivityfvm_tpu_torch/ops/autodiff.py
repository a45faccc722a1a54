"""Differentiable effective diffusivity: d(Deff)/d(D-field) by the adjoint
method (torch port of ``effectivediffusivityfvm_tpu.ops.autodiff``).

Deff is a differentiable function of the per-cell diffusivity field, so
microstructure optimization, inverse problems and models that
backpropagate through the physics plug straight into ``torch.autograd``.

Differentiating through the solver's iterations would keep thousands of
iterations' state alive; instead the solve is a ``torch.autograd.Function``
whose backward uses the implicit-function theorem.  With ``J(d) = Deff(d,
x*(d))`` where ``A(d) x* = b(d)``:

    dJ/dd = dJ/dd|_x - lam^T (d(A x* - b)/dd),     A lam = dJ/dx

With no mask the assembled operator is symmetric, so the adjoint system is
solved by the same multigrid-PCG solve (``solve_mgcg``, right-hand side
``dJ/dx``, start 0): one more linear solve per gradient on the same engine
and the same kernels (K1/K2, or K4/K5 for float32 grids past the
whole-cycle size).  There is no backward kernel: the partials come from
autograd through the cheap, explicit assembly and flux maps at the
converged point.

``deff_and_grad`` returns ``(value, grad)``; ``make_differentiable_deff``
returns the differentiable callable.  A ``(B, ny, nx)`` field runs through
``solve_mgcg_batched`` (per-image freezing, one adjoint batch solve) and
gives a ``(B,)`` Deff whose gradient is each image's own, the counterpart
of ``jax.vmap`` over the JAX callable.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable

from . import fvm
from .flux import boundary_deff, make_flux_spec

__all__ = ["make_differentiable_deff", "deff_and_grad"]


class _Problem:
    """The boundary values and solver settings behind one callable, and the
    iterations of its last forward and adjoint solves."""

    def __init__(self, c_left, c_right, solve_kw):
        self.c_left = c_left
        self.c_right = c_right
        self.solve_kw = solve_kw
        self.iterations = {"forward": None, "adjoint": None}

    def solve(self, d_field, rhs=None, x0=None):
        """``x`` solving ``A(d) x = b(d)`` (or ``= rhs``) from ``x0``
        (default: the linear ramp from ``c_left`` to ``c_right``); records
        the iterations under "forward" or "adjoint"."""
        from ..solvers.multigrid import solve_mgcg, solve_mgcg_batched

        coeffs = fvm.fvm_coefficients(d_field, self.c_left, self.c_right)
        if rhs is not None:
            coeffs = coeffs._replace(b=rhs)
        spec = make_flux_spec(d_field, self.c_left, self.c_right)
        if x0 is None:
            nx = d_field.shape[-1]
            x0 = (torch.arange(nx, dtype=d_field.dtype, device=d_field.device)
                  / nx * (self.c_right - self.c_left)
                  + self.c_left).expand(d_field.shape)
        solve = solve_mgcg_batched if d_field.dim() == 3 else solve_mgcg
        res = solve(coeffs, spec, x0, **self.solve_kw)
        self.iterations["forward" if rhs is None else "adjoint"] = res.iters
        return res.x

    def functional(self, d_field, x):
        return boundary_deff(
            make_flux_spec(d_field, self.c_left, self.c_right), x)

    def residual_map(self, d_field, x):
        c = fvm.fvm_coefficients(d_field, self.c_left, self.c_right)
        return fvm.apply_operator(c, x) - c.b


class _Deff(torch.autograd.Function):
    """Deff of ``d_field``; backward by one adjoint solve."""

    @staticmethod
    def forward(ctx, d_field, problem):
        d = d_field.detach()
        x_star = problem.solve(d)
        ctx.problem = problem
        ctx.save_for_backward(d, x_star)
        return problem.functional(d, x_star)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        problem = ctx.problem
        d, x_star = ctx.saved_tensors
        with torch.enable_grad():
            # dJ/dd and dJ/dx at the converged point
            d_ = d.detach().requires_grad_()
            x_ = x_star.detach().requires_grad_()
            gd_direct, gx = torch.autograd.grad(
                problem.functional(d_, x_), (d_, x_), grad_outputs=g)
        # the adjoint solve A lam = dJ/dx (A symmetric: the same operator)
        lam = problem.solve(d, rhs=gx, x0=torch.zeros_like(x_star))
        with torch.enable_grad():
            # -lam^T dF/dd with F(d, x) = A(d) x - b(d), evaluated at x*
            d_ = d.detach().requires_grad_()
            (gd_adjoint,) = torch.autograd.grad(
                problem.residual_map(d_, x_star), d_, grad_outputs=-lam)
        return gd_direct + gd_adjoint, None


def make_differentiable_deff(c_left: float = 0.0, c_right: float = 1.0,
                             tol: float = 1e-10, max_iter: int = 2_000,
                             check_every: int = 10,
                             solver_kw: Optional[dict] = None) -> Callable:
    """Build ``deff(d_field)``, differentiable with respect to ``d_field``:
    a scalar for ``(ny, nx)``, ``(B,)`` for ``(B, ny, nx)``.

    The forward pass runs MGCG to ``tol`` (relresidual) from the linear
    ramp; the backward pass solves the adjoint system with the same solver
    and assembles the gradient by the implicit function theorem.
    ``solver_kw`` goes to ``solve_mgcg``/``solve_mgcg_batched`` as it is
    (``use_pallas``, the cycle, ``plain=True`` for the kernels' plain
    versions on the card).  float64 is recommended for gradient checks;
    float32 works at matching tolerances.  ``deff.iterations`` holds the
    iterations of the last forward and adjoint solves.
    """
    kw = dict(tol=tol, max_iter=max_iter, check_every=check_every,
              criterion="relresidual")
    kw.update(solver_kw or {})
    problem = _Problem(c_left, c_right, kw)

    def deff(d_field: torch.Tensor) -> torch.Tensor:
        return _Deff.apply(d_field, problem)

    deff.iterations = problem.iterations
    return deff


def deff_and_grad(d_field: torch.Tensor, c_left: float = 0.0,
                  c_right: float = 1.0, **opts):
    """``(Deff, dDeff/dd_field)`` in one call (per image for a batch)."""
    f = make_differentiable_deff(c_left, c_right, **opts)
    d = d_field.detach().requires_grad_()
    value = f(d)
    (grad,) = torch.autograd.grad(value.sum(), d)
    return value.detach(), grad
