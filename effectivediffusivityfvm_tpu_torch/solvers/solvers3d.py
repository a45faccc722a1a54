"""3D solvers on the 7-point voxel operator (torch port of
``effectivediffusivityfvm_tpu.solvers.solvers3d``): weighted Jacobi,
red-black SOR, diagonal-PCG and multigrid-PCG.

* The 2x2x2 aggregation-Galerkin hierarchy: restriction sums a block,
  prolongation injects piecewise-constant corrections, and ``R A P`` of a
  7-point stencil is again a 7-point stencil in closed form.  Odd dims are
  padded with decoupled identity voxels (diag 1, couplings 0, b 0).
* ``solve_mgcg_3d*`` run the JAX package's banded fused engine
  (``use_pallas="tiled3d"``): ``k`` whole PCG iterations per window on K7
  (:func:`~..ops.kernels.cgstep3d.cg_steps3d`), with the driver refreshing
  every active volume at every check through the stored level 0 and K6's
  banded cycle (:func:`~..ops.kernels.vcycle3d.v_cycle3d_tiled`); or, for
  ``use_pallas=False`` and the cycles that engine does not take, the PCG
  engine (:mod:`.pcg`) with the plain torch :func:`v_cycle_3d`, the JAX
  package's XLA engine.
* ``solve_jacobi_3d*`` and ``solve_rbsor_3d*`` run the sweep driver
  (:mod:`.driver`) with the 3D Jacobi sweep or the red-black SOR sweep
  (``(k+i+j)`` parity colouring) in plain PyTorch, as the JAX package runs
  them in XLA; ``solve_cg_3d*`` run the PCG engine (:mod:`.pcg`) with the
  3D matvec and the reciprocal diagonal.

The pipelines' 3D ``dmg`` is :mod:`.dmg3d`.  All solvers return
:class:`~.driver.SolveResult`; the batched variants take ``(B, nz, ny,
nx)``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops import fvm3d
from ..ops.fvm3d import FluxSpec3D, StencilCoeffs3D, boundary_deff_3d
from ..ops.kernels.cgstep import batch_sum
from ..ops.kernels.cgstep3d import cg_steps3d, cg_steps3d_reference
from ..ops.kernels.vcycle3d import (HALO_Z, band_z_for, pad_op_3d,
                                    pad_shape_3d, v_cycle3d_tiled,
                                    v_cycle3d_tiled_reference)
from . import driver
from .driver import SolveResult
from .multigrid import GridOps, plain_cycle
from .pcg import run_pcg
from .rbsor import omega_opt, sweeps_fn

__all__ = [
    "solve_jacobi_3d", "solve_rbsor_3d", "solve_cg_3d", "solve_mgcg_3d",
    "solve_jacobi_3d_batched", "solve_rbsor_3d_batched",
    "solve_cg_3d_batched", "solve_mgcg_3d_batched",
    "restrict_3d", "prolong_3d", "coarsen_3d", "build_hierarchy_3d",
    "v_cycle_3d", "tiled3d_system",
]


# --------------------------------------------------------------------------
# 3D aggregation-Galerkin multigrid
# --------------------------------------------------------------------------

def _pad_even_3d(c: StencilCoeffs3D) -> StencilCoeffs3D:
    """Pad odd dims with decoupled identity voxels so 2x2x2 blocks align."""
    nz, ny, nx = c.diag.shape[-3:]
    return pad_op_3d(c, nz % 2, ny % 2, nx % 2)


def _zsum(a):
    """Pair-sum the z axis."""
    return a[..., 0::2, :, :] + a[..., 1::2, :, :]


def _ysum(a):
    return a[..., 0::2, :] + a[..., 1::2, :]


def _xsum(a):
    return a[..., 0::2] + a[..., 1::2]


def restrict_3d(r):
    """``R r``: sum over aligned 2x2x2 blocks (z, then y, then x)."""
    return _xsum(_ysum(_zsum(r)))


def prolong_3d(e):
    """``P e``: piecewise-constant injection (repeat 2x2x2)."""
    for dim in (-3, -2, -1):
        e = e.repeat_interleave(2, dim=dim)
    return e


def coarsen_3d(c: StencilCoeffs3D) -> StencilCoeffs3D:
    """Galerkin ``R A P`` for aligned 2x2x2 aggregation of a 7-point
    stencil, in closed form: the coarse face conductance is the sum of the
    four fine conductances crossing it, the coarse diagonal the block's
    fine diagonals less twice its internal conductances (decoupled where it
    falls to ``1e-6`` of the restricted diagonal)."""
    c = _pad_even_3d(c)

    t_e = _zsum(_ysum(c.a_e))            # (..., K, I, nx)
    a_e_c = t_e[..., 1::2]               # crossing x faces
    t_s = _xsum(_zsum(c.a_s))            # (..., K, ny, J)
    a_s_c = t_s[..., 1::2, :]
    t_d = _ysum(_xsum(c.a_d))            # (..., nz, I, J)
    a_d_c = t_d[..., 1::2, :, :]

    # internal (within-block) couplings: even index along their axis
    internal = t_e[..., 0::2] + t_s[..., 0::2, :] + t_d[..., 0::2, :, :]

    diag_r = restrict_3d(c.diag)
    diag_c = diag_r - 2.0 * internal
    b_c = restrict_3d(c.b)

    zx = torch.zeros_like(a_e_c[..., :, :, :1])
    zy = torch.zeros_like(a_s_c[..., :, :1, :])
    zz = torch.zeros_like(a_d_c[..., :1, :, :])
    a_e_c = torch.cat([a_e_c[..., :, :, :-1], zx], dim=-1)
    a_w_c = torch.cat([zx, a_e_c[..., :, :, :-1]], dim=-1)
    a_s_c = torch.cat([a_s_c[..., :, :-1, :], zy], dim=-2)
    a_n_c = torch.cat([zy, a_s_c[..., :, :-1, :]], dim=-2)
    a_d_c = torch.cat([a_d_c[..., :-1, :, :], zz], dim=-3)
    a_u_c = torch.cat([zz, a_d_c[..., :-1, :, :]], dim=-3)

    floor = 1e-6 * diag_r
    ok = diag_c > floor
    diag_inv = torch.where(ok, 1.0 / torch.where(ok, diag_c, 1.0), 0.0)
    return StencilCoeffs3D(a_w_c, a_e_c, a_n_c, a_s_c, a_u_c, a_d_c,
                           diag_c, diag_inv, b_c)


def build_hierarchy_3d(c: StencilCoeffs3D, min_size: int = 4,
                       pad_levels: bool = False) -> List[StencilCoeffs3D]:
    """Fine-to-coarse operator list; stops when a dim is ``<= min_size``.
    ``pad_levels=True`` stores every level padded to even dims (decoupled
    identity voxels), as the kernels require."""
    if pad_levels:
        c = _pad_even_3d(c)
    levels = [c]
    while min(c.diag.shape[-3:]) > min_size:
        c = coarsen_3d(c)
        if pad_levels:
            c = _pad_even_3d(c)
        levels.append(c)
    return levels


_OPS_3D = GridOps(3, fvm3d.jacobi_sweep_3d, fvm3d.apply_operator_3d,
                  restrict_3d, prolong_3d)


def v_cycle_3d(levels: List[StencilCoeffs3D], r, **kw):
    """One V(nu1, nu2) cycle of :func:`~.multigrid.plain_cycle` on a 3D
    hierarchy (:func:`build_hierarchy_3d`) and ``(..., nz, ny, nx)``
    residuals: the JAX package's XLA ``v_cycle_3d``."""
    return plain_cycle(_OPS_3D, levels, r, **kw)


def tiled3d_system(coeffs: StencilCoeffs3D, d_field=None, *, min_size: int):
    """The banded engine's system for a ``(B, nz, ny, nx)`` batch, as the
    JAX engine builds it: the band (``band_z_for``: 12 window fields when
    matrix-free, else 18), the hierarchy of the operator padded to
    ``pad_shape_3d``, and K7's matrix-free arguments (``{}`` without
    ``d_field``; else the padded D, zero in the pads, and ``geom = (dy dz /
    dx, dx dz / dy, dx dy / dz, dy dz / (dx / 2), nx)`` of the unpadded
    volume)."""
    nz, ny, nx = coeffs.diag.shape[-3:]
    band = band_z_for(nz, ny + ny % 2, nx + nx % 2,
                      coeffs.diag.element_size(),
                      fields=12 if d_field is not None else 18)
    pz, py, px = pad_shape_3d(nz, ny, nx, band)
    levels = build_hierarchy_3d(pad_op_3d(coeffs, pz - nz, py - ny, px - nx),
                                min_size=min_size, pad_levels=True)
    if len(levels) < 2:
        raise ValueError(f"the fused 3D engine needs two levels or more: a "
                         f"{(nz, ny, nx)} volume has a dim <= min_size="
                         f"{min_size}")
    if d_field is None:
        return levels, {}
    pz, py, px = levels[0].diag.shape[-3:]
    dx, dy, dz = 1.0 / nx, 1.0 / ny, 1.0 / nz
    d_pad = F.pad(d_field.to(coeffs.diag.dtype),
                  (0, px - nx, 0, py - ny, 0, pz - nz))
    geom = (dy * dz / dx, dx * dz / dy, dx * dy / dz, dy * dz / (dx / 2.0),
            nx)
    return levels, dict(d_field=d_pad.contiguous(), geom=geom)


def _engine_auto_3d(nu1: int, nu2: int):
    """The 3D engine for V(nu1, nu2): the banded fused engine ``"tiled3d"``
    for V(nu, nu) with ``1 <= nu <= HALO_Z - 1``, in float32 and float64 and
    on any device (the JAX package takes it only for float32 on a TPU),
    else ``False`` (the plain torch cycle under ``run_pcg``), as the JAX
    package's ``_pallas_auto_3d`` returns for the cycles it does not take.
    It reads the cycle only, never the device, so the CPU path runs the
    algorithm the card runs."""
    if nu1 != nu2 or not 1 <= nu1 <= HALO_Z - 1:
        return False
    return "tiled3d"


def _run_mgcg3d_fused(coeffs, spec, x0, *, tol, max_iter, check_every,
                      criterion, nu, mg_omega, coarse_iters, min_size, over,
                      d_field=None, first_window=1,
                      plain=False) -> SolveResult:
    """Batched 3D MGCG on the banded fused engine: windows of ``k`` whole
    PCG iterations on K7, the driver refreshing between them.

    Check, restart, divergence and freeze semantics follow the JAX engine:
    a window is ``first_window`` iterations first, then ``check_every``,
    cut by ``max_iter`` (a cut window still checks); at every check each
    active volume is refreshed with the stored level 0 and K6's banded cycle
    (``r = b - A x``, ``p = z = M r``, ``rz = <r, z>``); the in-kernel stop
    threshold is the mean-|r| tolerance times ``nz*ny*nx`` (for
    ``relresidual`` also times ``mean|b|``); the tripwire is ``1e3 * best *
    nz*ny*nx``; the best iterate is kept and returned for a volume whose
    divergence net fired.  With ``d_field`` K7 rebuilds level 0 from D
    (matrix-free) while the refresh stays stored, the JAX engine's own small
    stencil mismatch.  The loop reads ``any(active)`` back to the host once
    per window.

    ``plain=True`` runs the same solve on the kernels' plain versions (for
    comparisons on the card).
    """
    bsz, nz, ny, nx = coeffs.b.shape
    dtype = x0.dtype
    dev = x0.device
    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    mg = dict(omega=mg_omega, nu=nu, coarse_iters=coarse_iters, over=over)
    levels, mf = tiled3d_system(coeffs, d_field, min_size=min_size)
    cg_fn = cg_steps3d_reference if plain else cg_steps3d
    cycle_fn = v_cycle3d_tiled_reference if plain else v_cycle3d_tiled
    lvl0 = levels[0]
    pz, py, px = lvl0.diag.shape[-3:]

    def unpad(a):
        return a[..., :nz, :ny, :nx]

    def mean_abs(v):
        return torch.mean(torch.abs(unpad(v)), dim=(-3, -2, -1))

    def where4(m, a, b):
        return torch.where(m[:, None, None, None], a, b)

    def fresh(xp):
        r = lvl0.b - fvm3d.apply_operator_3d(lvl0, xp)
        z = cycle_fn(levels, r, **mg)
        return r, z, batch_sum(r * z)

    bscale = mean_abs(lvl0.b) if criterion == "relresidual" else None
    npts = torch.tensor(nz * ny * nx, dtype=dtype, device=dev)
    if criterion == "residual":
        stop_sum = torch.full((bsz,), tol, dtype=dtype, device=dev) * npts
    elif criterion == "relresidual":
        stop_sum = tol_ * bscale * npts
    else:
        stop_sum = torch.zeros((bsz,), dtype=dtype, device=dev)

    def deff_fn(xp):
        return boundary_deff_3d(spec, unpad(xp))

    # x is updated in place by the kernels: start from a private copy
    x = F.pad(x0, (0, px - nx, 0, py - ny, 0, pz - nz)).clone(
        memory_format=torch.contiguous_format)
    r, p, rz = fresh(x)

    def scal(v):
        return torch.full((bsz,), v, dtype=dtype, device=dev)

    deff, deff_old, pc, conv = scal(1.0), scal(5.0), scal(100.0), scal(100.0)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    x_best = x.clone()
    best = mean_abs(r)
    bad = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter:
        active = tol_ < torch.abs(pc)
        if not bool(active.any()):
            break
        k = (min(first_window, max_iter) if it == 0
             else min(check_every, max_iter - it))
        hi_sum = 1e3 * best * npts
        x, r, p, rz, kdone = cg_fn(levels, x, r, p, rz, active.to(dtype),
                                   stop_sum, hi_sum, k, **mg, **mf)
        it += k
        iters = iters + torch.where(active, kdone, 0)
        # a window cut by max_iter lands a check all the same
        do_check = ((it - first_window) % check_every == 0) or it >= max_iter
        upd = active & do_check
        r_true, z_true, rz_true = fresh(x)
        r = where4(upd, r_true, r)
        p = where4(upd, z_true, p)
        rz = torch.where(upd, rz_true, rz)
        r_mean = mean_abs(r_true)
        improved = upd & (r_mean < best)
        x_best = where4(improved, x, x_best)
        best = torch.where(improved, r_mean, best)
        diverged = upd & (~torch.isfinite(r_mean) | (r_mean > 1e3 * best))

        deff_new = deff_fn(x)
        if criterion == "deff":
            pc_new = (deff_old - deff_new) / deff_old
            deff_old = torch.where(upd, deff_new, deff_old)
        elif criterion == "relresidual":
            pc_new = r_mean / bscale
        else:
            pc_new = r_mean
        deff = torch.where(upd, deff_new, deff)
        pc = torch.where(upd, pc_new, pc)
        pc = torch.where(diverged, 0.0, pc)
        conv = torch.where(upd, pc_new, conv)
        bad = bad | diverged

    # last iterate unless the divergence net fired
    x_out = where4(bad, x_best, x)
    deff_out = deff_fn(x_out)
    if criterion == "relresidual":
        conv = torch.where(bad, best / bscale, conv)
    elif criterion != "deff":
        conv = torch.where(bad, best, conv)
    return SolveResult(x=unpad(x_out), deff=deff_out, conv=conv, iters=iters)


def _mgcg3_core(coeffs, spec, x0, *, tol, max_iter, check_every, criterion,
                batched, nu1, nu2, mg_omega, coarse_iters, min_size, over,
                use_pallas=None, d_field=None, first_window=1,
                plain=False) -> SolveResult:
    # the 3D matrix-free engine does not force first_window = 1 (the JAX
    # package measured it neutral under a full opening window)
    first_window = driver.resolve_first_window(first_window, check_every,
                                               criterion)
    if use_pallas is None:
        use_pallas = _engine_auto_3d(nu1, nu2)
    elif use_pallas == "tiled3d":
        if _engine_auto_3d(nu1, nu2) is False:
            raise ValueError(f"the fused 3D engine implements V(nu, nu) with "
                             f"1 <= nu <= {HALO_Z - 1}, got V({nu1}, {nu2})")
    elif use_pallas is not False:
        raise ValueError(f"unknown use_pallas {use_pallas!r} for the 3D "
                         "solvers (None, False or 'tiled3d')")
    if use_pallas is False:
        levels = build_hierarchy_3d(coeffs, min_size=min_size)

        def precond(r, active=None):
            return v_cycle_3d(levels, r, nu1=nu1, nu2=nu2, omega=mg_omega,
                              coarse_iters=coarse_iters, over=over)
        return _pcg3(coeffs, spec, x0, precond, batched, tol=tol,
                     max_iter=max_iter, check_every=check_every,
                     criterion=criterion)
    if not batched:
        coeffs = StencilCoeffs3D(*(a[None] for a in coeffs))
        spec = FluxSpec3D(*(torch.as_tensor(a)[None] for a in spec))
        x0 = x0[None]
        if d_field is not None:
            d_field = d_field[None]
    res = _run_mgcg3d_fused(
        coeffs, spec, x0, tol=tol, max_iter=max_iter,
        check_every=check_every, criterion=criterion, nu=nu1,
        mg_omega=mg_omega, coarse_iters=coarse_iters, min_size=min_size,
        over=over, d_field=d_field, first_window=first_window, plain=plain)
    if not batched:
        res = SolveResult(*(a[0] for a in res))
    return res


def solve_mgcg_3d(coeffs, spec, x0, *, omega: float = 0.0, tol: float = 1e-8,
                  max_iter: int = 10_000, check_every: int = 0,
                  criterion: str = "residual", nu1: int = 1, nu2: int = 1,
                  mg_omega=0.8, coarse_iters: int = 32, min_size: int = 4,
                  over: float = 1.8, use_pallas=None, d_field=None,
                  first_window: int = 1) -> SolveResult:
    """3D multigrid-PCG on one ``(nz, ny, nx)`` volume.

    ``use_pallas``: ``None`` = auto (the banded fused engine for V(nu, nu),
    ``nu <= 3``, else ``False``), ``"tiled3d"`` = that engine, ``False`` =
    the JAX package's XLA engine: :func:`v_cycle_3d` (any V(nu1, nu2))
    preconditioning :func:`~.pcg.run_pcg`.  ``d_field``: the
    diffusivity volume behind ``coeffs``, which must then be exactly the
    plain unmasked ``fvm_coefficients_3d(d_field, cl, cr)``; K7 rebuilds
    its level 0 from it (matrix-free).  ``first_window``: iterations in the
    first window (``0`` = auto, see :func:`.driver.resolve_first_window`).
    ``omega`` is accepted for signature parity and unused.

    The kernels run on a CUDA tensor and their plain PyTorch versions on a
    CPU tensor.
    """
    del omega
    return _mgcg3_core(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                       check_every=driver.resolve_check_every(check_every, 10),
                       criterion=criterion, batched=False, nu1=nu1, nu2=nu2,
                       mg_omega=mg_omega, coarse_iters=coarse_iters,
                       min_size=min_size, over=over, use_pallas=use_pallas,
                       d_field=d_field, first_window=first_window)


def solve_mgcg_3d_batched(coeffs, spec, x0, *, omega: float = 0.0,
                          tol: float = 1e-8, max_iter: int = 10_000,
                          check_every: int = 0, criterion: str = "residual",
                          nu1: int = 1, nu2: int = 1, mg_omega=0.8,
                          coarse_iters: int = 32, min_size: int = 4,
                          over: float = 1.8, use_pallas=None, d_field=None,
                          first_window: int = 1) -> SolveResult:
    """Batched :func:`solve_mgcg_3d` on ``(B, nz, ny, nx)`` (``d_field``
    too); converged volumes are frozen while the rest iterate."""
    del omega
    return _mgcg3_core(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                       check_every=driver.resolve_check_every(check_every, 10),
                       criterion=criterion, batched=True, nu1=nu1, nu2=nu2,
                       mg_omega=mg_omega, coarse_iters=coarse_iters,
                       min_size=min_size, over=over, use_pallas=use_pallas,
                       d_field=d_field, first_window=first_window)


# --------------------------------------------------------------------------
# Sweep solvers
# --------------------------------------------------------------------------

def _jacobi_sweeps_3d(coeffs: StencilCoeffs3D, omega: float):
    def run(x: torch.Tensor, k: int, active=None) -> torch.Tensor:
        y = x
        for _ in range(k):
            y = fvm3d.jacobi_sweep_3d(coeffs, y, omega)
        if active is None:
            return y
        return torch.where(active[:, None, None, None], y, x)
    return run


def _monitors(coeffs, spec):
    return dict(deff_fn=lambda x: boundary_deff_3d(spec, x),
                resid_fn=lambda x: fvm3d.residual_3d(coeffs, x))


def solve_jacobi_3d(coeffs, spec, x0, *, omega: float = 2.0 / 3.0,
                    tol: float = 1e-5, max_iter: int = 500_000,
                    check_every: int = 0,
                    criterion: str = "deff") -> SolveResult:
    """Weighted Jacobi on one volume to the reference stopping rule
    (:func:`.driver.run_single`)."""
    omega = omega or 2.0 / 3.0
    return driver.run_single(
        _jacobi_sweeps_3d(coeffs, omega), coeffs, spec, x0, tol=tol,
        max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion, **_monitors(coeffs, spec))


def solve_jacobi_3d_batched(coeffs, spec, x0, *, omega: float = 2.0 / 3.0,
                            tol: float = 1e-5, max_iter: int = 500_000,
                            check_every: int = 0,
                            criterion: str = "deff") -> SolveResult:
    """Batched :func:`solve_jacobi_3d` with per-volume freezing."""
    omega = omega or 2.0 / 3.0
    return driver.run_batched(
        _jacobi_sweeps_3d(coeffs, omega), coeffs, spec, x0, tol=tol,
        max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion, **_monitors(coeffs, spec))


def solve_rbsor_3d(coeffs, spec, x0, *, omega: float = 0.0,
                   tol: float = 1e-5, max_iter: int = 500_000,
                   check_every: int = 0,
                   criterion: str = "deff") -> SolveResult:
    """Red-black SOR on one volume, coloured by ``(k+i+j)`` parity; ``omega``
    0 picks :func:`~.rbsor.omega_opt` of the largest dim."""
    n = max(x0.shape[-3:])
    return driver.run_single(
        sweeps_fn(coeffs, omega or omega_opt(n, n), 3,
                  fvm3d.neighbor_sum_3d), coeffs, spec, x0, tol=tol,
        max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion, **_monitors(coeffs, spec))


def solve_rbsor_3d_batched(coeffs, spec, x0, *, omega: float = 0.0,
                           tol: float = 1e-5, max_iter: int = 500_000,
                           check_every: int = 0,
                           criterion: str = "deff") -> SolveResult:
    """Batched :func:`solve_rbsor_3d` with per-volume freezing."""
    n = max(x0.shape[-3:])
    return driver.run_batched(
        sweeps_fn(coeffs, omega or omega_opt(n, n), 3,
                  fvm3d.neighbor_sum_3d), coeffs, spec, x0, tol=tol,
        max_iter=max_iter,
        check_every=driver.resolve_check_every(check_every, 10_000),
        criterion=criterion, **_monitors(coeffs, spec))


# --------------------------------------------------------------------------
# Diagonal-PCG
# --------------------------------------------------------------------------

def _pcg3(coeffs, spec, x0, precond, batched, *, tol, max_iter, check_every,
          criterion):
    """``run_pcg`` on the 3D matvec with ``precond(r, active)``."""
    return run_pcg(
        matvec=lambda p: fvm3d.apply_operator_3d(coeffs, p),
        precond=precond,
        b=coeffs.b,
        x0=x0,
        deff_fn=lambda x: boundary_deff_3d(spec, x),
        tol=tol, max_iter=max_iter, check_every=check_every,
        criterion=criterion, grid_ndim=3, batched=batched,
    )


def _diag_precond(coeffs):
    return lambda r, active=None: coeffs.diag_inv * r


def solve_cg_3d(coeffs, spec, x0, *, omega: float = 0.0, tol: float = 1e-8,
                max_iter: int = 100_000, check_every: int = 0,
                criterion: str = "residual") -> SolveResult:
    """Jacobi-preconditioned CG on one volume (:func:`~.pcg.run_pcg`);
    ``omega`` is signature parity."""
    return _pcg3(coeffs, spec, x0, _diag_precond(coeffs), False, tol=tol,
                 max_iter=max_iter,
                 check_every=driver.resolve_check_every(check_every, 100),
                 criterion=criterion)


def solve_cg_3d_batched(coeffs, spec, x0, *, omega: float = 0.0,
                        tol: float = 1e-8, max_iter: int = 100_000,
                        check_every: int = 0,
                        criterion: str = "residual") -> SolveResult:
    """Batched :func:`solve_cg_3d` with per-volume freezing."""
    return _pcg3(coeffs, spec, x0, _diag_precond(coeffs), True, tol=tol,
                 max_iter=max_iter,
                 check_every=driver.resolve_check_every(check_every, 100),
                 criterion=criterion)
