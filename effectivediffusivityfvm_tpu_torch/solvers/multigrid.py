"""Geometric multigrid hierarchy and the MGCG solves (torch port of
``effectivediffusivityfvm_tpu.solvers.multigrid``).

Aggregates are aligned 2x2 cell blocks: restriction sums a block,
prolongation injects piecewise-constant corrections, and the Galerkin coarse
operator ``R A P`` of a 5-point stencil is again a 5-point stencil in closed
form (coarse face conductance = sum of the two fine conductances crossing
it; coarse diagonal = sum of fine diagonals - 2 x internal conductances).
Odd dimensions are padded with decoupled identity cells (diag 1, couplings
0, b 0).

The solve runs PCG with one V-cycle as the preconditioner on one of the
JAX package's engines, picked by ``use_pallas``:

* the fused engines, V(nu, nu): "cgstep" (K1/K2), where each window of up
  to ``check_every`` iterations is one K1 call that also refreshes and
  restarts CG from the true residual at the window's end, and, for float32
  grids past the whole-cycle size, the banded "tiled" engine (K4/K5, with
  an optional matrix-free level 0), whose driver refreshes between windows;
* the cycle-only engines under :func:`~.pcg.run_pcg`: ``False``, the plain
  torch :func:`v_cycle` (any V(nu1, nu2), the JAX package's default off a
  TPU), ``True``, K2's cycle, and ``"tiledcycle"``, K4's banded cycle.

Masked systems must use the symmetric assembly
(``fvm_coefficients(..., symmetric=True)``).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch
import torch.nn.functional as F

from ..ops import fvm
from ..ops.flux import BoundaryFluxSpec, boundary_deff
from ..ops.kernels.cgstep import batch_sum, cg_steps, cg_steps_reference
from ..ops.kernels import vcycle as k2
from ..ops.kernels.cgstep_tiled import (cg_steps_tiled,
                                        cg_steps_tiled_reference)
from ..ops.kernels.vcycle import (MAX_NU, LevelArgs, smoothing_schedule,
                                  v_cycle_reference)
from ..ops.kernels.vcycle_tiled import (HALO, fits_whole_cycle, tiled_band,
                                        tiled_pad_shape, v_cycle_tiled,
                                        v_cycle_tiled_reference)
from .driver import SolveResult, resolve_check_every, resolve_first_window
from .pcg import run_pcg

__all__ = ["restrict", "prolong", "coarsen", "build_hierarchy", "v_cycle",
           "cycle_fn", "tiled_system", "solve_mgcg", "solve_mgcg_batched"]


def _pad_op(c: fvm.StencilCoeffs, py: int, px: int) -> fvm.StencilCoeffs:
    """Pad by ``(py, px)`` trailing rows/cols of decoupled identity cells."""
    if not (py or px):
        return c

    def z(a):
        return F.pad(a, (0, px, 0, py))

    diag = F.pad(c.diag, (0, px, 0, py), value=1.0)
    return fvm.StencilCoeffs(a_w=z(c.a_w), a_e=z(c.a_e), a_n=z(c.a_n),
                             a_s=z(c.a_s), diag=diag,
                             diag_inv=fvm.guarded_inverse(diag), b=z(c.b))


def _pad_even(c: fvm.StencilCoeffs) -> fvm.StencilCoeffs:
    """Pad odd dims with decoupled identity cells so 2x2 blocks align."""
    ny, nx = c.diag.shape[-2], c.diag.shape[-1]
    return _pad_op(c, ny % 2, nx % 2)


def _blocks(a):
    """``(..., 2i, 2j) -> (..., i, 2, j, 2)`` view."""
    ny, nx = a.shape[-2], a.shape[-1]
    return a.reshape(a.shape[:-2] + (ny // 2, 2, nx // 2, 2))


def restrict(r):
    """``R r``: sum over aligned 2x2 blocks."""
    return _blocks(r).sum(dim=(-3, -1))


def prolong(e):
    """``P e``: piecewise-constant injection (repeat 2x2)."""
    return e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def coarsen(c: fvm.StencilCoeffs) -> fvm.StencilCoeffs:
    """Galerkin coarse operator ``R A P`` for aligned 2x2 aggregation."""
    c = _pad_even(c)
    ae_b = _blocks(c.a_e)
    as_b = _blocks(c.a_s)
    a_e_c = ae_b[..., :, :, :, 1].sum(-2)      # crossing coarse E faces
    a_s_c = as_b[..., :, 1, :, :].sum(-1)      # crossing coarse S faces
    internal = ae_b[..., :, :, :, 0].sum(-2) + as_b[..., :, 0, :, :].sum(-1)

    diag_c = restrict(c.diag) - 2.0 * internal
    b_c = restrict(c.b)

    z_col = torch.zeros_like(a_e_c[..., :, :1])
    z_row = torch.zeros_like(a_s_c[..., :1, :])
    a_e_c = torch.cat([a_e_c[..., :, :-1], z_col], dim=-1)
    a_w_c = torch.cat([z_col, a_e_c[..., :, :-1]], dim=-1)
    a_s_c = torch.cat([a_s_c[..., :-1, :], z_row], dim=-2)
    a_n_c = torch.cat([z_row, a_s_c[..., :-1, :]], dim=-2)

    # Cells whose coarse diagonal lost all significance to cancellation
    # (contrast-1e6 media in fp32) are decoupled: diag_inv = 0.
    floor = 1e-6 * restrict(c.diag)
    ok = diag_c > floor
    diag_inv = torch.where(ok, 1.0 / torch.where(ok, diag_c, 1.0), 0.0)
    return fvm.StencilCoeffs(a_w_c, a_e_c, a_n_c, a_s_c, diag_c, diag_inv, b_c)


def build_hierarchy(c: fvm.StencilCoeffs, min_size: int = 8,
                    pad_levels: bool = False) -> List[fvm.StencilCoeffs]:
    """Fine-to-coarse operator list; stops when a dim is ``<= min_size``.
    ``pad_levels=True`` stores every level padded to even dims, as the
    kernels require."""
    if pad_levels:
        c = _pad_even(c)
    levels = [c]
    while min(c.diag.shape[-2], c.diag.shape[-1]) > min_size:
        c = coarsen(c)
        if pad_levels:
            c = _pad_even(c)
        levels.append(c)
    return levels


class GridOps(NamedTuple):
    """A dimension's pieces of the plain cycle: the number of grid dims,
    the damped-Jacobi sweep ``sweep(c, e, omega)`` of ``A e = c.b``, the
    operator ``apply(c, e)``, restriction and prolongation."""

    ndim: int
    sweep: Callable
    apply: Callable
    restrict: Callable
    prolong: Callable


def _pad_to(r, shape):
    """Zero-pad the trailing ``len(shape)`` dims of ``r`` up to ``shape``."""
    pad = []
    for n, m in zip(reversed(shape), reversed(r.shape)):
        pad += [0, n - m]
    return F.pad(r, pad) if any(pad) else r


def _crop(e, shape):
    """The leading ``shape`` of the trailing ``len(shape)`` dims of ``e``."""
    return e[(Ellipsis,) + tuple(slice(0, n) for n in shape)]


def plain_cycle(ops: GridOps, levels, r, *, nu1=1, nu2=1, omega=0.8,
                coarse_iters=32, level=0, over=1.8):
    """One V(nu1, nu2) cycle on the residual equation ``A e = r`` in plain
    torch, with ``ops``' sweep, operator and transfers: the JAX package's
    XLA cycle (``v_cycle``, ``v_cycle_3d``), operation for operation.

    ``levels`` is a hierarchy (padded or not); ``r`` is ``(..., *grid)`` on
    level 0's unpadded shape, and so is the result.  ``omega``: a scalar
    damping, or a tuple of ``nu1`` (== ``nu2``) per-sweep factors, applied
    in order pre-smoothing and reversed post-smoothing; the coarse solve
    sweeps ``coarse_iters`` times at the schedule's last factor.  ``over``
    scales the prolongated correction.  Unlike the kernels' cycles this
    one smooths with the stored diagonal, which differs from
    ``1/diag_inv`` at the coarse cells the hierarchy floored."""
    if nu1 < 1 or nu2 < 0:
        raise ValueError(f"V({nu1}, {nu2}): nu1 >= 1 and nu2 >= 0 required")
    nd = ops.ndim
    shp = levels[level].diag.shape[-nd:]
    out = r.shape[-nd:]
    r_lvl = _pad_to(r, shp)
    c = levels[level]._replace(b=r_lvl)      # the sweeps' right-hand side
    om1 = smoothing_schedule(omega, nu1)
    om2 = smoothing_schedule(omega, nu2)
    e = torch.zeros_like(r_lvl)
    if level == len(levels) - 1:
        for _ in range(coarse_iters):
            e = ops.sweep(c, e, om1[-1])
        return _crop(e, out)

    for w in om1:
        e = ops.sweep(c, e, w)
    # the correction equation's residual, padded to twice the coarse shape
    # (an odd level gets a zero plane) and restricted
    res = r_lvl - ops.apply(c, e)
    nxt = levels[level + 1].diag.shape[-nd:]
    res = _pad_to(res, tuple(2 * n for n in nxt))
    e_c = plain_cycle(ops, levels, ops.restrict(res), nu1=nu1, nu2=nu2,
                      omega=omega, coarse_iters=coarse_iters,
                      level=level + 1, over=over)
    e = e + over * _crop(ops.prolong(e_c), shp)
    for w in reversed(om2):
        e = ops.sweep(c, e, w)
    return _crop(e, out)


_OPS_2D = GridOps(2, fvm.jacobi_sweep, fvm.apply_operator, restrict,
                  prolong)


def v_cycle(levels: List[fvm.StencilCoeffs], r, **kw):
    """One V(nu1, nu2) cycle of :func:`plain_cycle` on a 2D hierarchy
    (:func:`build_hierarchy`) and ``(..., ny, nx)`` residuals: the JAX
    package's XLA ``v_cycle``."""
    return plain_cycle(_OPS_2D, levels, r, **kw)


# the largest nu of the kernels' V(nu, nu) cycles, by engine
_ENGINE_MAX_NU = {"cgstep": MAX_NU, "tiled": HALO - 2, True: MAX_NU,
                  "tiledcycle": HALO}


def _engine_auto(ny: int, nx: int, dtype, nu1: int = 1, nu2: int = 1):
    """The engine for an ``(ny, nx)`` V(nu1, nu2) solve: the fused engine
    the JAX package takes on a TPU (``_pallas_auto``) -- the banded
    ``"tiled"`` for float32 past the whole-cycle size (even-padded), else
    ``"cgstep"`` -- where that engine takes the cycle, else ``False`` (the
    plain torch cycle under ``run_pcg``), as ``_pallas_auto`` returns for
    V(nu1 != nu2).  It reads the shape, the type and the cycle, never the
    device, so the CPU path runs the algorithm the card runs."""
    if dtype == torch.float32 and not fits_whole_cycle(ny + ny % 2,
                                                       nx + nx % 2):
        engine = "tiled"
    else:
        engine = "cgstep"
    if nu1 != nu2 or not 1 <= nu1 <= _ENGINE_MAX_NU[engine]:
        return False
    return engine


def cycle_fn(raw: fvm.StencilCoeffs, engine, *, nu1, nu2, mg_omega,
             coarse_iters, min_size, over, plain=False):
    """``cycle(r, active=None)`` on ``(B, ny, nx)`` residuals, with the
    hierarchy of ``raw`` (and the kernel's level tables) built once.

    ``engine``: ``False``, :func:`v_cycle` on ``build_hierarchy(raw)``,
    V(nu1, nu2); ``True``, K2 on the even-padded hierarchy, ``r`` padded
    to level 0; ``"tiled"``, K4 on the operator padded to
    ``tiled_pad_shape``, levels as :func:`tiled_system` builds them.  The
    kernels take V(nu1, nu1).  K2 takes the batch's ``active`` flags, so a
    frozen image does no work; K4 and the plain cycle compute a frozen
    image's cycle, which the PCG loop discards.  ``plain=True`` runs the
    kernels' plain versions (on a CPU tensor their wrappers do anyway)."""
    bsz, ny, nx = raw.b.shape
    if engine is False:
        levels = build_hierarchy(raw, min_size=min_size)

        def cycle(rr, active=None):
            return v_cycle(levels, rr, nu1=nu1, nu2=nu2, omega=mg_omega,
                           coarse_iters=coarse_iters, over=over)
        return cycle
    if engine == "tiled":
        py, px = tiled_pad_shape(ny, nx, tiled_band(ny, nx,
                                                    raw.b.element_size()))
        levels = build_hierarchy(_pad_op(raw, py - ny, px - nx),
                                 min_size=min_size, pad_levels=True)
        fn = v_cycle_tiled_reference if plain else v_cycle_tiled
    else:
        levels = build_hierarchy(raw, min_size=min_size, pad_levels=True)
        fn = v_cycle_reference if plain else k2.v_cycle
    py, px = levels[0].diag.shape[-2:]
    kw = dict(omega=mg_omega, nu=nu1, coarse_iters=coarse_iters, over=over)
    if not plain and raw.b.is_cuda:
        kw["level_args"] = LevelArgs(levels, levels[0].b)

    def cycle(rr, active=None):
        rp = F.pad(rr, (0, px - nx, 0, py - ny))
        extra = {} if engine == "tiled" or active is None else dict(
            active=active)
        return fn(levels, rp, **kw, **extra)[..., :ny, :nx]
    return cycle


def tiled_system(coeffs, d_field=None, *, min_size: int):
    """The banded engine's system for a ``(B, ny, nx)`` batch: the hierarchy
    of the operator padded to ``tiled_pad_shape``, and the matrix-free
    arguments of K5 (``{}`` without ``d_field``; else the padded D, zero in
    the pads, and ``geom = (dy/dx, dx/dy, dy/(dx/2), nx)`` of the unpadded
    grid)."""
    ny, nx = coeffs.diag.shape[-2], coeffs.diag.shape[-1]
    py, px = tiled_pad_shape(ny, nx,
                             tiled_band(ny, nx, coeffs.diag.element_size()))
    levels = build_hierarchy(_pad_op(coeffs, py - ny, px - nx),
                             min_size=min_size, pad_levels=True)
    if d_field is None:
        return levels, {}
    dx, dy = 1.0 / nx, 1.0 / ny
    d_pad = F.pad(d_field.to(coeffs.diag.dtype), (0, px - nx, 0, py - ny))
    return levels, dict(d_field=d_pad,
                        geom=(dy / dx, dx / dy, dy / (dx / 2.0), nx))


def _run_mgcg_fused(coeffs, spec, x0, *, tol, max_iter, check_every,
                    criterion, nu, mg_omega, coarse_iters, min_size, over,
                    first_window, engine="cgstep", d_field=None,
                    plain=False) -> SolveResult:
    """Batched MGCG, ``k`` whole PCG iterations per kernel call.

    ``engine="cgstep"``: K1 (:func:`~..ops.kernels.cgstep.cg_steps`) runs a
    window and refreshes and restarts CG from the true residual in its
    tail.  ``engine="tiled"`` (grids past the whole-cycle size): the
    hierarchy is built on the operator padded to ``tiled_pad_shape``, K5
    (:func:`~..ops.kernels.cgstep_tiled.cg_steps_tiled`) runs a window, and
    the driver refreshes every active image at every check with the stored
    level 0 and K4's cycle (``r = b - A x``, ``p = z = M r``, ``rz =
    <r, z>``).  With ``d_field`` K5 rebuilds level 0 from D (matrix-free)
    while the refresh stays stored -- the JAX engine's own small stencil
    mismatch, kept as it is.

    Check, restart, divergence and freeze semantics follow the JAX fused
    driver: a window is ``first_window`` iterations first, then
    ``check_every``, cut by ``max_iter`` (a cut window still checks); the
    in-kernel stop threshold is the mean-|r| tolerance times ``ny*nx`` over
    the physical cells; the tripwire is ``1e3 * best * ny*nx``; the best
    iterate is kept and returned for an image whose divergence net fired.
    The loop reads ``any(active)`` back to the host once per window.

    ``plain=True`` runs the same solve on the kernels' plain versions (for
    comparisons on the card).
    """
    bsz, ny, nx = coeffs.b.shape
    dtype = x0.dtype
    dev = x0.device
    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    mg = dict(omega=mg_omega, nu=nu, coarse_iters=coarse_iters, over=over)
    if engine == "tiled":
        levels, tiled_kw = tiled_system(coeffs, d_field, min_size=min_size)
        cg_fn = cg_steps_tiled_reference if plain else cg_steps_tiled
        kcycle = v_cycle_tiled_reference if plain else v_cycle_tiled
    else:
        levels = build_hierarchy(coeffs, min_size=min_size, pad_levels=True)
        cg_fn = cg_steps_reference if plain else cg_steps
        kcycle = v_cycle_reference if plain else k2.v_cycle
    lvl0 = levels[0]
    py, px = lvl0.diag.shape[-2], lvl0.diag.shape[-1]

    def unpad(a):
        return a[..., :ny, :nx]

    def mean_abs(v):
        return torch.mean(torch.abs(unpad(v)), dim=(-2, -1))

    def where3(m, a, b):
        return torch.where(m[:, None, None], a, b)

    def fresh(xp):
        r = lvl0.b - fvm.apply_operator(lvl0, xp)
        z = kcycle(levels, r, **mg)
        return r, z, batch_sum(r * z)

    bscale = mean_abs(lvl0.b) if criterion == "relresidual" else None
    npts = torch.tensor(ny * nx, dtype=dtype, device=dev)
    if criterion == "residual":
        stop_sum = torch.full((bsz,), tol, dtype=dtype, device=dev) * npts
    elif criterion == "relresidual":
        stop_sum = tol_ * bscale * npts
    else:
        stop_sum = torch.zeros((bsz,), dtype=dtype, device=dev)

    def deff_fn(xp):
        return boundary_deff(spec, unpad(xp))

    # x is updated in place by the kernels: start from a private copy
    x = F.pad(x0, (0, px - nx, 0, py - ny)).clone(
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
        if engine == "tiled":
            x, r, p, rz, kdone = cg_fn(
                levels, x, r, p, rz, active.to(dtype), stop_sum, hi_sum, k,
                **mg, **tiled_kw)
        else:
            x, r, p, rz, kdone, sr_true = cg_fn(
                levels, x, r, p, rz, active.to(dtype), stop_sum, hi_sum, k,
                **mg)
        it += k
        iters = iters + torch.where(active, kdone, 0)
        # a window cut by max_iter lands a check all the same
        do_check = ((it - first_window) % check_every == 0) or it >= max_iter
        upd = active & do_check
        if engine == "tiled":
            r_true, z_true, rz_true = fresh(x)
            r = where3(upd, r_true, r)
            p = where3(upd, z_true, p)
            rz = torch.where(upd, rz_true, rz)
            r_mean = mean_abs(r_true)
        else:
            r_mean = sr_true / npts
        improved = upd & (r_mean < best)
        x_best = where3(improved, x, x_best)
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
    x_out = where3(bad, x_best, x)
    deff_out = deff_fn(x_out)
    if criterion == "relresidual":
        conv = torch.where(bad, best / bscale, conv)
    elif criterion != "deff":
        conv = torch.where(bad, best, conv)
    return SolveResult(x=unpad(x_out), deff=deff_out, conv=conv, iters=iters)


def _resolve_engine(use_pallas, ny, nx, dtype, nu1, nu2):
    """``use_pallas`` (the JAX package's values) to an engine: ``None`` is
    :func:`_engine_auto`; a fused engine (``"cgstep"``, ``"tiled"``) needs
    V(nu, nu), and a forced kernel engine a ``nu1`` within its kernel's,
    on every device.  The cycle-only kernel engines (``True``,
    ``"tiledcycle"``) run V(nu1, nu1) whatever ``nu2``, as the JAX
    package's do."""
    if use_pallas is None:
        return _engine_auto(ny, nx, dtype, nu1, nu2)
    if use_pallas is False:
        return False
    if use_pallas is not True and use_pallas not in _ENGINE_MAX_NU:
        raise ValueError(f"unknown use_pallas {use_pallas!r}")
    if nu1 != nu2 and use_pallas in ("cgstep", "tiled"):
        raise ValueError("the fused CG engines implement V(nu, nu)")
    if not 1 <= nu1 <= _ENGINE_MAX_NU[use_pallas]:
        raise ValueError(f"use_pallas={use_pallas!r} takes V(nu, nu) with "
                         f"1 <= nu <= {_ENGINE_MAX_NU[use_pallas]}, got "
                         f"nu={nu1}")
    return use_pallas


def _mgcg_core(coeffs, spec, x0, *, tol, max_iter, check_every, criterion,
               batched, nu1, nu2, mg_omega, coarse_iters, min_size, over,
               first_window, use_pallas=None, d_field=None,
               plain=False) -> SolveResult:
    first_window = resolve_first_window(first_window, check_every, criterion,
                                        matrix_free=d_field is not None)
    engine = _resolve_engine(use_pallas, coeffs.diag.shape[-2],
                             coeffs.diag.shape[-1], coeffs.diag.dtype, nu1,
                             nu2)
    if engine in ("cgstep", "tiled"):
        if not batched:
            coeffs = fvm.StencilCoeffs(*(a[None] for a in coeffs))
            spec = BoundaryFluxSpec(*(a[None] for a in spec))
            x0 = x0[None]
            if d_field is not None:
                d_field = d_field[None]
        res = _run_mgcg_fused(
            coeffs, spec, x0, tol=tol, max_iter=max_iter,
            check_every=check_every, criterion=criterion, nu=nu1,
            mg_omega=mg_omega, coarse_iters=coarse_iters, min_size=min_size,
            over=over, first_window=first_window, engine=engine,
            d_field=d_field if engine == "tiled" else None, plain=plain)
        if not batched:
            res = SolveResult(*(a[0] for a in res))
        return res

    # the cycle-only engines: run_pcg with one cycle a preconditioner
    # application (the plain cycle, K2, or K4 as "tiled")
    raw = coeffs if batched else fvm.StencilCoeffs(*(a[None] for a in coeffs))
    cycle = cycle_fn(raw, "tiled" if engine == "tiledcycle" else engine,
                     nu1=nu1, nu2=nu2, mg_omega=mg_omega,
                     coarse_iters=coarse_iters, min_size=min_size, over=over,
                     plain=plain)

    def precond(r, active=None):
        return cycle(r, active) if batched else cycle(r[None])[0]

    return run_pcg(
        matvec=lambda p: fvm.apply_operator(coeffs, p), precond=precond,
        b=coeffs.b, x0=x0, deff_fn=lambda x: boundary_deff(spec, x),
        tol=tol, max_iter=max_iter, check_every=check_every,
        criterion=criterion, grid_ndim=2, batched=batched)


def solve_mgcg(coeffs, spec, x0, *, tol: float = 1e-8, max_iter: int = 10_000,
               check_every: int = 0, criterion: str = "residual",
               nu1: int = 1, nu2: int = 1, mg_omega=0.8,
               coarse_iters: int = 32, min_size: int = 8, over: float = 1.8,
               use_pallas=None, d_field=None,
               first_window: int = 1, plain: bool = False) -> SolveResult:
    """Multigrid-preconditioned CG on one ``(ny, nx)`` image.

    ``criterion``: "residual" (mean |b - A x|), "relresidual" (divided by
    mean |b|) or "deff" (relative Deff change).  ``mg_omega`` is a scalar
    damping or a per-sweep tuple of ``nu1`` factors.  ``first_window`` is
    the length of the first kernel window (``0`` = auto, see
    :func:`~.driver.resolve_first_window`).

    ``use_pallas`` picks the engine, with the JAX signature: ``None`` =
    auto (:func:`_engine_auto`: ``"tiled"`` for float32 grids past the
    whole-cycle size, else ``"cgstep"``, where that engine takes the cycle;
    else ``False``), ``"cgstep"`` = K1/K2, ``"tiled"`` = the banded engine
    K4/K5, and the cycle-only engines under :func:`~.pcg.run_pcg`:
    ``False`` = the plain torch :func:`v_cycle` (any V(nu1, nu2)), ``True``
    = K2's cycle, ``"tiledcycle"`` = K4's; these two run V(nu1, nu1)
    whatever ``nu2``, as the JAX package's do.  A fused engine forced with
    V(nu1 != nu2) raises ``ValueError``.  ``first_window`` applies to the
    fused engines; under ``run_pcg`` the first check follows iteration 1.
    ``d_field``: the diffusivity field behind ``coeffs``, which must then be
    exactly the plain unmasked ``fvm_coefficients(d_field, cl, cr)``; the
    banded engine rebuilds its level 0 from it (matrix-free), the others
    ignore it.  Keep ``first_window=1`` with it (auto picks 1).

    The kernels run on a CUDA tensor and their plain PyTorch versions on a
    CPU tensor; ``plain=True`` runs the plain versions on a CUDA tensor too
    (for comparisons on the card).
    """
    return _mgcg_core(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                      check_every=resolve_check_every(check_every, 10),
                      criterion=criterion, batched=False, nu1=nu1, nu2=nu2,
                      mg_omega=mg_omega, coarse_iters=coarse_iters,
                      min_size=min_size, over=over, first_window=first_window,
                      use_pallas=use_pallas, d_field=d_field, plain=plain)


def solve_mgcg_batched(coeffs, spec, x0, *, tol: float = 1e-8,
                       max_iter: int = 10_000, check_every: int = 0,
                       criterion: str = "residual", nu1: int = 1,
                       nu2: int = 1, mg_omega=0.8, coarse_iters: int = 32,
                       min_size: int = 8, over: float = 1.8,
                       use_pallas=None, d_field=None,
                       first_window: int = 1,
                       plain: bool = False) -> SolveResult:
    """Batched :func:`solve_mgcg` on ``(B, ny, nx)`` (``d_field`` too);
    converged images are frozen while the rest iterate."""
    return _mgcg_core(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                      check_every=resolve_check_every(check_every, 10),
                      criterion=criterion, batched=True, nu1=nu1, nu2=nu2,
                      mg_omega=mg_omega, coarse_iters=coarse_iters,
                      min_size=min_size, over=over, first_window=first_window,
                      use_pallas=use_pallas, d_field=d_field, plain=plain)
