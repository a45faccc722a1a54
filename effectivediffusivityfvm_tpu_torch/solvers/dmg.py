"""kappa-robust solver for extreme-contrast multiphase media: deflated MGCG
(torch port of ``effectivediffusivityfvm_tpu.solvers.dmg``; solver
``dmg``).

The reference's demo setting (Dg = 1,237,500, kappa ~ 1e11) defeats
multigrid alone (it stalls on the per-gas-component near-kernel) and
component deflation alone (``dcg``: the fluid bridges stay ill-conditioned
under a diagonal preconditioner).  ``dmg`` combines both subspace
corrections in the form the JAX package established by measurement:

  1. The engine runs on the symmetric-equilibrated system ``A' = S A S``
     (unit diagonal).  The deflation space becomes ``W' = S^-1 W`` (the
     coarse apply is a weighted segment sum) and the coarse matrix is
     invariant: ``E' = W'^T A' W' = W^T A W``.
  2. Deflation is applied in the A-DEF2 form (Tang, Nabben, Vuik &
     Erlangga 2009): plain PCG with preconditioner
         M^-1 = (I - Q A) M_mg^-1 + Q,      Q = W E^-1 W^T
     and the deflated start ``x0 <- Q b + (I - Q A) x0``.
  3. The iteration runs in f64 (``||Q|| ~ 1e6``), while the V-cycle
     preconditioner runs in f32 by default.

The V-cycle is K2 (:func:`~..ops.kernels.vcycle.v_cycle`), K4
(:func:`~..ops.kernels.vcycle_tiled.v_cycle_tiled`) or, for a ``nu`` past
theirs, the plain torch :func:`~.multigrid.v_cycle`, picked by
:func:`_dmg_engine_auto` from the shape, the cycle's dtype and ``nu``, never
the device; ``use_pallas=False`` forces the plain cycle, which is the JAX
package's XLA ``v_cycle`` (its choice off a TPU).  ``plain=True`` runs the
kernels' plain versions (for comparisons on the card); on a CPU tensor the
kernels' wrappers run them anyway.  Needs f64 inputs (``Dtype:
float64``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import fvm
from ..ops.flux import boundary_deff
from ..ops.kernels.vcycle import MAX_NU
from ..ops.kernels.vcycle_tiled import HALO, fits_whole_cycle
from .deflation import (DeflationSpace, Segments, _coarse_apply, batch_defls,
                        batch_space, build_component_deflation)
from .driver import SolveResult, resolve_check_every
from .multigrid import cycle_fn
from .pcg import run_pcg

__all__ = ["solve_dmg", "solve_dmg_batched", "solve_dmg_refined"]


_MG_DEFAULTS = dict(nu=2, mg_omega=0.8, coarse_iters=32, min_size=16,
                    over=1.8)


def _mg_kw(kw):
    out = dict(_MG_DEFAULTS)
    out.update({k: kw[k] for k in _MG_DEFAULTS if k in kw})
    unknown = set(kw) - set(_MG_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown dmg options: {sorted(unknown)}")
    return out


def _dmg_engine_auto(shape, dtype, nu):
    """The cycle for a ``(.., ny, nx)`` solve whose V-cycle runs in
    ``dtype``: ``"tiled"`` (K4) for a float32 cycle whose even-padded grid
    is past the whole-cycle size (``nu <= HALO``), else ``True`` (K2, float32
    or float64, ``nu <= MAX_NU``), else ``False`` (the plain torch cycle).
    Shape, dtype and ``nu`` alone decide, as ``multigrid._engine_auto``
    decides for mgcg."""
    ny, nx = shape[-2], shape[-1]
    if (dtype == torch.float32 and nu <= HALO
            and not fits_whole_cycle(ny + ny % 2, nx + nx % 2)):
        return "tiled"
    return nu <= MAX_NU


def _resolve_engine(use_pallas, shape, dtype, nu):
    if use_pallas is None:
        return _dmg_engine_auto(shape, dtype, nu)
    if use_pallas is True or use_pallas is False or use_pallas == "tiled":
        return use_pallas
    raise ValueError(f"unknown use_pallas {use_pallas!r}")


def _solve_dmg_core(coeffs, spec, x0, defl: Optional[DeflationSpace], *,
                    batched, tol, max_iter, check_every, criterion, engine,
                    precond_f32, plain, nu, mg_omega, coarse_iters, min_size,
                    over) -> SolveResult:
    dtype = x0.dtype
    coeffs = fvm.decouple_empty_rows(coeffs)
    c_eq, s = fvm.equilibrate(coeffs)
    w = 1.0 / s                                  # = sqrt(diag): W' = S^-1 W

    # The hierarchy is built on the RAW operator, not the equilibrated one:
    # aggregation interpolation must follow the physical conductances (on
    # A' the smooth modes jump ~sqrt(contrast) across phase interfaces).
    # The raw cycle plugs into the equilibrated engine by r_raw = w r' and
    # z' = w e, so M'_mg = S^-1 M_mg S^-1 -- still SPD.
    pdt = torch.float32 if precond_f32 else dtype
    raw = fvm.StencilCoeffs(*(a.to(pdt) for a in coeffs))
    if not batched:
        raw = fvm.StencilCoeffs(*(a[None] for a in raw))
    cycle = cycle_fn(raw, engine, nu1=nu, nu2=nu, mg_omega=mg_omega,
                     coarse_iters=coarse_iters, min_size=min_size, over=over,
                     plain=plain)

    def matvec(p):
        return fvm.apply_operator(c_eq, p)

    if defl is not None:
        seg = Segments(defl)

        def q_apply(v):
            return _coarse_apply(defl, v, w, seg)

    def precond(r, active=None):
        rr = (w * r).to(pdt)
        zc = cycle(rr, active) if batched else cycle(rr[None])[0]
        z = w * zc.to(dtype)
        if defl is None:            # Q = 0: no coarse term (same numbers)
            return z
        # A-DEF2: M^-1 r = (I - Q A) z + Q r, deliberately NOT folded to the
        # one-apply z + Q(r - A z): algebraically equal, but the ~1e6
        # coarse amplification makes the two forms' rounding differ (the
        # folded form floors the refined demo-image solve at 3.5e-11, this
        # one reaches 6e-12, JAX solvers/dmg.py)
        return z - q_apply(matvec(z)) + q_apply(r)

    x0e = x0 / s
    x0h = (x0e if defl is None                    # deflated start
           else q_apply(c_eq.b) + x0e - q_apply(matvec(x0e)))
    res = run_pcg(
        matvec=matvec, precond=precond, b=c_eq.b, x0=x0h,
        deff_fn=lambda xh: boundary_deff(spec, s * xh),
        tol=tol, max_iter=max_iter,
        check_every=resolve_check_every(check_every, 10),
        criterion=criterion, grid_ndim=2, batched=batched,
    )
    return res._replace(x=s * res.x)


def _check_f64(x0, name):
    if x0.dtype != torch.float64:
        raise ValueError(f"{name} needs f64 inputs (set Dtype: float64)")


def solve_dmg(coeffs, spec, x0, *, omega: float = 0.0, tol: float = 1e-10,
              max_iter: int = 2_000, check_every: int = 0,
              criterion: str = "relresidual",
              member: Optional[np.ndarray] = None,
              defl: Optional[DeflationSpace] = None,
              precond_f32: bool = True, use_pallas=None, plain: bool = False,
              **mg) -> SolveResult:
    """Deflated multigrid-PCG (A-DEF2), single image, f64 in and out.

    ``criterion="residual"/"relresidual"`` are measured on the equilibrated
    system; ``"deff"`` applies the reference's percent-change rule on the
    recovered field.  MG knobs (``nu/mg_omega/coarse_iters/min_size/over``)
    pass through; ``precond_f32=False`` runs the V-cycle in f64 (on K2).
    ``use_pallas``: None = :func:`_dmg_engine_auto`, True = K2, "tiled" =
    K4, False = the plain torch cycle.  ``plain=True`` runs the cycle's plain version (for
    comparisons on the card).  ``omega`` is signature parity.
    """
    _check_f64(x0, "solve_dmg")
    if defl is None and member is not None:
        defl = build_component_deflation(coeffs, member)
    mg_kw = _mg_kw(mg)
    engine = _resolve_engine(use_pallas, x0.shape,
                             torch.float32 if precond_f32 else x0.dtype,
                             mg_kw["nu"])
    return _solve_dmg_core(
        coeffs, spec, x0, defl, batched=False, tol=tol, max_iter=max_iter,
        check_every=check_every, criterion=criterion, engine=engine,
        precond_f32=precond_f32, plain=plain, **mg_kw)


def solve_dmg_batched(coeffs, spec, x0, *, omega: float = 0.0,
                      tol: float = 1e-10, max_iter: int = 2_000,
                      check_every: int = 0, criterion: str = "relresidual",
                      members: Optional[np.ndarray] = None,
                      defls: Optional[list] = None,
                      precond_f32: bool = True, use_pallas=None,
                      plain: bool = False, **mg) -> SolveResult:
    """Batched deflated MGCG on ``(B, ny, nx)``: per-image deflation spaces
    zero-padded to the batch-wide maximum component count, and one batched
    PCG loop on a ``(B, ny, nx)`` cycle in which a converged image is frozen
    (on K2 it does no cycle work).  The JAX package vmaps its single solve
    over the batch on its XLA cycle; the images' results agree with their
    solo runs at the same check schedule."""
    _check_f64(x0, "solve_dmg_batched")
    if defls is None and members is not None:
        defls = batch_defls(coeffs, members)
    space = (None if defls is None
             else batch_space(defls, x0.shape[1:], x0.dtype, x0.device))
    mg_kw = _mg_kw(mg)
    engine = _resolve_engine(use_pallas, x0.shape,
                             torch.float32 if precond_f32 else x0.dtype,
                             mg_kw["nu"])
    return _solve_dmg_core(
        coeffs, spec, x0, space, batched=True, tol=tol, max_iter=max_iter,
        check_every=check_every, criterion=criterion, engine=engine,
        precond_f32=precond_f32, plain=plain, **mg_kw)


def solve_dmg_refined(coeffs, spec, x0, *, tol: float = 1e-12,
                      max_outers: int = 12, inner_iters: int = 120,
                      inner_tol: float = 1e-4, check_every: int = 0,
                      member: Optional[np.ndarray] = None,
                      defl: Optional[DeflationSpace] = None,
                      precond_f32: bool = True, use_pallas=None,
                      plain: bool = False, **mg) -> SolveResult:
    """Correction-form refinement around :func:`solve_dmg`, the
    deepest-accuracy driver for extreme-contrast single images.

    Iterating PCG on x directly floors at the classical f64 attainable
    accuracy ``eps ||A'|| ||x'||``; solving the CORRECTION system
    ``A d = r`` from zero each outer lets the true residual keep shrinking.
    The outer loop runs on the host.  ``iters`` counts TOTAL inner
    iterations; ``conv`` is the true f64 relative residual of the
    accumulated solution.
    """
    if defl is None and member is not None:
        defl = build_component_deflation(coeffs, member)
    bmean = torch.mean(torch.abs(coeffs.b))

    def rel_of(x):
        return float(torch.mean(torch.abs(coeffs.b - fvm.apply_operator(
            coeffs, x))) / bmean)

    x = x0
    total = 0
    rel = rel_of(x)
    for _ in range(max_outers):
        if rel <= tol:
            break
        r = coeffs.b - fvm.apply_operator(coeffs, x)
        res = solve_dmg(coeffs._replace(b=r), spec, torch.zeros_like(x),
                        tol=inner_tol, max_iter=inner_iters,
                        check_every=check_every, criterion="relresidual",
                        defl=defl, precond_f32=precond_f32,
                        use_pallas=use_pallas, plain=plain, **mg)
        x = x + res.x
        total += int(res.iters)
        rel = rel_of(x)
    return SolveResult(x=x, deff=boundary_deff(spec, x),
                       conv=torch.tensor(rel, dtype=x.dtype),
                       iters=torch.tensor(total, dtype=torch.int32))
