"""Solver registry: route a config's solver name to an implementation
(torch port of ``effectivediffusivityfvm_tpu.solvers.dispatch``).

Ported: ``jacobi`` (plain PyTorch sweeps), ``jacobi_pallas`` (the K3 CUDA
kernel) and ``mgcg`` (the K1/K2 CUDA kernels, or K4/K5 on the banded
engine).  The JAX package's other solver names are accepted by the
configuration and refused here, naming the ROADMAP slice that ports them.
"""

from __future__ import annotations

from .driver import SolveResult

__all__ = ["solve", "solve_batched", "needs_spd", "SolveResult"]

# solver name -> ROADMAP slice that ports it
_NOT_PORTED = {"rbsor": 3, "cg": 3, "cgir": 3, "dcg": 3, "dmg": 3}


def needs_spd(name: str) -> bool:
    """True if ``name`` requires the symmetrized (SPD) masked assembly.

    Krylov solvers (cg/mgcg/cgir/dcg) need symmetry for their convergence
    theory; the K3 kernel (``jacobi_pallas``) rebuilds the east/south
    couplings from a_w/a_n, which would apply a transposed operator to an
    unsymmetric masked system.  The symmetrized assembly has the identical
    exact solution (see fvm.fvm_coefficients), so every pipeline routes
    3-phase systems for these solvers through it via this single predicate.
    """
    return name in ("cg", "mgcg", "cgir", "dcg", "dmg", "jacobi_pallas")


def _lookup(name: str, batched: bool):
    if name == "jacobi":
        from .jacobi import solve_jacobi, solve_jacobi_batched
        return solve_jacobi_batched if batched else solve_jacobi
    if name == "jacobi_pallas":
        from .jacobi_pallas import (solve_jacobi_pallas,
                                    solve_jacobi_pallas_batched)
        return solve_jacobi_pallas_batched if batched else solve_jacobi_pallas
    if name == "mgcg":
        from .multigrid import solve_mgcg, solve_mgcg_batched
        solve = solve_mgcg_batched if batched else solve_mgcg

        def mgcg(coeffs, spec, x0, *, omega=0.0, **kw):
            del omega   # accepted for signature parity, as the JAX solver does
            return solve(coeffs, spec, x0, **kw)
        return mgcg
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"solver {name!r} is not ported to the torch package yet "
            f"(ROADMAP slice {_NOT_PORTED[name]})")
    raise ValueError(f"unknown solver {name!r}")


def solve(name, coeffs, spec, x0, **kw) -> SolveResult:
    return _lookup(name, batched=False)(coeffs, spec, x0, **kw)


def solve_batched(name, coeffs, spec, x0, **kw) -> SolveResult:
    return _lookup(name, batched=True)(coeffs, spec, x0, **kw)
