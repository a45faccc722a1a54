"""Solver registry: route a config's solver name to an implementation
(torch port of ``effectivediffusivityfvm_tpu.solvers.dispatch``).

Every solver of the JAX package: ``jacobi`` and ``rbsor`` (plain PyTorch
sweeps), ``jacobi_pallas`` (the K3 CUDA kernel), ``cg``, ``cgir`` and
``dcg`` (the PCG engines in plain PyTorch, as the JAX package runs them in
XLA), ``mgcg`` (the K1/K2 CUDA kernels, or K4/K5 on the banded engine) and
``dmg`` (deflated PCG with a K2 or K4 V-cycle).  All share one call
signature and :class:`~.driver.SolveResult`.
"""

from __future__ import annotations

from .driver import SolveResult

__all__ = ["solve", "solve_batched", "needs_spd", "SolveResult"]


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
    if name == "rbsor":
        from .rbsor import solve_rbsor, solve_rbsor_batched
        return solve_rbsor_batched if batched else solve_rbsor
    if name == "cg":
        from .cg import solve_cg, solve_cg_batched
        return solve_cg_batched if batched else solve_cg
    if name == "cgir":
        from .refine import solve_cgir, solve_cgir_batched
        return solve_cgir_batched if batched else solve_cgir
    if name == "dcg":
        from .deflation import solve_dcg, solve_dcg_batched
        return solve_dcg_batched if batched else solve_dcg
    if name == "dmg":
        from .dmg import solve_dmg, solve_dmg_batched
        return solve_dmg_batched if batched else solve_dmg
    raise ValueError(f"unknown solver {name!r}")


def solve(name, coeffs, spec, x0, **kw) -> SolveResult:
    return _lookup(name, batched=False)(coeffs, spec, x0, **kw)


def solve_batched(name, coeffs, spec, x0, **kw) -> SolveResult:
    return _lookup(name, batched=True)(coeffs, spec, x0, **kw)
