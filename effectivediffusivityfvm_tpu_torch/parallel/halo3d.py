"""Z-slab sharded 3D solves with halo exchange (torch port of
``effectivediffusivityfvm_tpu.parallel.halo3d``).

A volume ``(nz, ny, nx)`` is split into z-slabs over a mesh row's ``sp``
shards (and a batch over its ``dp`` rows, see :mod:`.mesh`).  The 7-point
stencil needs one ghost plane a side per sweep or matvec, exchanged with
the neighbouring shards; the Deff, residual and CG monitors sum the
shards' partials.

  * :func:`sharded_solve_jacobi_3d`: the sweep driver;
  * :func:`sharded_solve_cg_3d`: diagonal-PCG on the PCG engine;
  * :func:`sharded_solve_mgcg_3d`: multigrid-PCG on the PCG engine, the
    hierarchy coarsened shard-locally while a slab keeps two planes or
    more, then gathered into a replicated tail that runs K6's whole cycle
    (:func:`~..ops.kernels.vcycle3d.v_cycle3d`) on every device for
    V(nu, nu) with ``nu <= MAX_NU3``, and for other cycles the plain torch
    :func:`~..solvers.solvers3d.v_cycle_3d`, which the JAX package runs
    there for every cycle.

The PCG solves run ``solvers.pcg.run_pcg`` on a :class:`~.mesh.
ShardedField` (:func:`.sharded_pcg.run_pcg_rows`), their dots and
``mean|r|`` summed per shard in float64 and rounded once.  Correctness
contract (tested): a sharded solve equals the JAX package's of the same
system, with identical iteration counts.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..ops.fvm3d import FluxSpec3D, StencilCoeffs3D
from ..ops.kernels.vcycle import smoothing_schedule
from ..ops.kernels.vcycle3d import (MAX_NU3, Level3Args, v_cycle3d,
                                    v_cycle3d_reference)
from ..solvers import driver
from ..solvers.driver import SolveResult
from ..solvers.solvers3d import (_xsum, _ysum, _zsum, build_hierarchy_3d,
                                 prolong_3d, restrict_3d, v_cycle_3d)
from .halo import RowSystem, _place, _unplace
from .mesh import Mesh, ShardedField, all_gather, halo_strips, psum
from .sharded_pcg import run_pcg_rows

__all__ = ["sharded_solve_jacobi_3d", "sharded_solve_cg_3d",
           "sharded_solve_mgcg_3d"]


def _halo_planes(xs):
    """``(ups, downs)``: each slab's ghost planes (its neighbours' last and
    first planes), zeros beyond the volume."""
    return halo_strips(xs, 1, dim=-3)


def _neighbor_sum_local(c_row, xs):
    """``sum_nb a_nb x_nb`` of every slab of a row (one-plane exchange)."""
    ups, downs = _halo_planes(xs)
    out = []
    for c, x, up, down in zip(c_row, xs, ups, downs):
        xu = torch.cat([up, x[..., :-1, :, :]], dim=-3)
        xd = torch.cat([x[..., 1:, :, :], down], dim=-3)
        zy = torch.zeros_like(x[..., :, :1, :])
        xn = torch.cat([zy, x[..., :, :-1, :]], dim=-2)
        xs_ = torch.cat([x[..., :, 1:, :], zy], dim=-2)
        zx = torch.zeros_like(x[..., :, :, :1])
        xw = torch.cat([zx, x[..., :, :, :-1]], dim=-1)
        xe = torch.cat([x[..., :, :, 1:], zx], dim=-1)
        out.append(c.a_w * xw + c.a_e * xe + c.a_n * xn + c.a_s * xs_
                   + c.a_u * xu + c.a_d * xd)
    return out


def _deff_local(s_row, xs):
    """Boundary-flux Deff ``(B_l,)`` of a row, the slabs' flux sums added
    (on shard 0's device)."""
    nz_g = xs[0].shape[-3] * len(xs)
    ny = xs[0].shape[-2]
    acc = torch.promote_types(xs[0].dtype, torch.float32)
    parts = []
    for spec, x in zip(s_row, xs):
        cl = spec.c_left[..., None, None]
        cr = spec.c_right[..., None, None]
        ihdx = spec.inv_half_dx[..., None, None]
        mfl = (spec.d_left * (x[..., :, :, 0] - cl) * ihdx).to(acc)
        mfr = (spec.d_right * (cr - x[..., :, :, -1]) * ihdx).to(acc)
        parts.append(torch.sum(mfl, dim=(-2, -1))
                     + torch.sum(mfr, dim=(-2, -1)))
    q = psum(parts)[0] / (2.0 * ny * nz_g)
    spec = s_row[0]
    denom = (spec.c_right - spec.c_left).to(acc)
    return (q / denom).to(xs[0].dtype)


class _Row3(RowSystem):
    """One dp row's z-slab system for the PCG engine; its preconditioner
    the reciprocal diagonal (``cg``)."""

    grid_ndim = 3

    def neighbor_sum(self, xs):
        return _neighbor_sum_local(self.c, xs)

    def deff(self, xs):
        return _deff_local(self.s, xs)

    def precond(self, rs, live):
        del live
        return [c.diag_inv * r for c, r in zip(self.c, rs)]


def _solve(coeffs, spec, x0, mesh, make_row, **kw) -> SolveResult:
    """The PCG engine over ``mesh`` with ``make_row(c_row, s_row)``'s rows;
    an unbatched volume is solved on dp row 0."""
    batched, c_rows, s_rows, x_rows = _place(mesh, coeffs, spec, x0, 3)
    if not batched:
        c_rows, s_rows, x_rows = c_rows[:1], s_rows[:1], x_rows[:1]
    rows = [make_row(c, s) for c, s in zip(c_rows, s_rows)]
    res = run_pcg_rows(rows, x_rows, shape=x0.shape, batched=batched, **kw)
    dev = x0.device
    return _unplace(batched, res.x.shards,
                    [res.deff.to(dev), res.conv.to(dev), res.iters.to(dev)],
                    dev, grid_ndim=3)


# ------------------------------------------------------------- Jacobi

def sharded_solve_jacobi_3d(
    coeffs: StencilCoeffs3D,
    spec: FluxSpec3D,
    x0: torch.Tensor,
    mesh: Mesh,
    *,
    omega: float = 2.0 / 3.0,
    tol: float = 1e-5,
    max_iter: int = 500_000,
    check_every: int = 10_000,
    criterion: str = "deff",
) -> SolveResult:
    """Z-slab sharded (and batch-sharded) Jacobi solve on ``mesh``:
    ``(nz, ny, nx)`` runs the single-volume driver, ``(B, nz, ny, nx)`` the
    batched one with per-volume freezing.  The result lies on ``x0``'s
    device."""
    omega = omega or 2.0 / 3.0
    dev = x0.device
    batched, c_rows, s_rows, x_rows = _place(mesh, coeffs, spec, x0, 3)
    dp = mesh.dp

    def sweep_row(c_row, xs):
        nbs = _neighbor_sum_local(c_row, xs)
        return [(1.0 - omega) * x + omega * (c.b + nb) * c.diag_inv
                for c, x, nb in zip(c_row, xs, nbs)]

    def resid_row(c_row, xs):
        nbs = _neighbor_sum_local(c_row, xs)
        parts = [torch.sum(torch.abs(c.b - (c.diag * x - nb)),
                           dim=(-3, -2, -1))
                 for c, x, nb in zip(c_row, xs, nbs)]
        return psum(parts)[0] / (xs[0][0].numel() * len(xs))

    def per_image(fn, x):
        v = torch.cat([fn(d, row).to(dev) for d, row in enumerate(x.shards)])
        return v if batched else v[0]

    def sweeps(x, k, active=None):
        rows = x.shards
        for _ in range(k):
            rows = [sweep_row(c_rows[d], rows[d]) for d in range(dp)]
        if active is not None:
            rows = [[torch.where(x.part(active, d, n.device)[:, None, None,
                                                             None], n, o)
                     for n, o in zip(rows[d], x.shards[d])]
                    for d in range(dp)]
        return x.like(rows)

    kw = dict(
        tol=tol, max_iter=max_iter, check_every=check_every,
        criterion=criterion,
        deff_fn=lambda x: per_image(lambda d, r: _deff_local(s_rows[d], r),
                                    x),
        resid_fn=lambda x: per_image(lambda d, r: resid_row(c_rows[d], r),
                                     x))
    field = ShardedField(x_rows, x0.shape, x0.dtype, dev)
    run = driver.run_batched if batched else driver.run_single
    res = run(sweeps, coeffs, spec, field, **kw)
    return _unplace(batched, res.x.shards, res[1:], dev, grid_ndim=3)


# ------------------------------------------------------------- CG

def sharded_solve_cg_3d(
    coeffs: StencilCoeffs3D,
    spec: FluxSpec3D,
    x0: torch.Tensor,
    mesh: Mesh,
    *,
    omega: float = 0.0,
    tol: float = 1e-8,
    max_iter: int = 100_000,
    check_every: int = 10_000,
    criterion: str = "residual",
) -> SolveResult:
    """Diagonal-PCG over z-slabs: the halo-exchanged matvec, the dots
    summed over the slabs, ``check_every`` clamped to 100 as the JAX
    package clamps it.  ``omega`` is signature parity."""
    del omega
    return _solve(coeffs, spec, x0, mesh, _Row3, tol=tol, max_iter=max_iter,
                  check_every=min(check_every, 100), criterion=criterion)


# ------------------------------------------------------ sharded multigrid

def _coarsen_local(c_row) -> List[StencilCoeffs3D]:
    """Slab-local 2x2x2 Galerkin coarsening of a z-sharded operator.

    ``solvers3d.coarsen_3d``'s closed form except at the slabs' z edges:
    the coupling into the next slab lives in the local ``a_d`` of the last
    fine plane (the odd-plane block sum keeps it), and the first coarse
    plane's ``a_u`` is the previous slab's last coarse ``a_d`` (0 on the
    first slab).  Needs even local dims."""
    parts = []
    for c in c_row:
        t_e = _zsum(_ysum(c.a_e))
        t_s = _xsum(_zsum(c.a_s))
        t_d = _ysum(_xsum(c.a_d))
        a_e_c, a_s_c, a_d_c = t_e[..., 1::2], t_s[..., 1::2, :], \
            t_d[..., 1::2, :, :]
        internal = t_e[..., 0::2] + t_s[..., 0::2, :] + t_d[..., 0::2, :, :]
        diag_r = restrict_3d(c.diag)
        zx = torch.zeros_like(a_e_c[..., :, :, :1])
        zy = torch.zeros_like(a_s_c[..., :, :1, :])
        a_e_c = torch.cat([a_e_c[..., :, :, :-1], zx], dim=-1)
        a_w_c = torch.cat([zx, a_e_c[..., :, :, :-1]], dim=-1)
        a_s_c = torch.cat([a_s_c[..., :, :-1, :], zy], dim=-2)
        a_n_c = torch.cat([zy, a_s_c[..., :, :-1, :]], dim=-2)
        parts.append((a_w_c, a_e_c, a_n_c, a_s_c, a_d_c,
                      diag_r - 2.0 * internal, diag_r, restrict_3d(c.b)))
    halos, _ = _halo_planes([p[4] for p in parts])
    out = []
    for (a_w_c, a_e_c, a_n_c, a_s_c, a_d_c, diag_c, diag_r, b_c), halo in \
            zip(parts, halos):
        a_u_c = torch.cat([halo, a_d_c[..., :-1, :, :]], dim=-3)
        ok = diag_c > 1e-6 * diag_r
        diag_inv = torch.where(ok, 1.0 / torch.where(ok, diag_c, 1.0), 0.0)
        out.append(StencilCoeffs3D(a_w_c, a_e_c, a_n_c, a_s_c, a_u_c, a_d_c,
                                   diag_c, diag_inv, b_c))
    return out


def _smooth_local(c_row, xs, bs, omega):
    nbs = _neighbor_sum_local(c_row, xs)
    return [(1.0 - omega) * x + omega * (b + nb) * c.diag_inv
            for c, x, b, nb in zip(c_row, xs, bs, nbs)]


def _gathered_levels_3d(c_row, min_size, pad_levels=True):
    """Per slab, the hierarchy of the row's level ``c_row`` gathered along z
    and, padded for K6 (``pad_levels``), K6's level tables on a CUDA
    device; built once per device."""
    fields = [all_gather([getattr(c, f) for c in c_row], dim=-3)
              for f in StencilCoeffs3D._fields]
    built = {}
    out = []
    for s, c in enumerate(c_row):
        dev = c.diag.device
        if dev not in built:
            levels = build_hierarchy_3d(
                StencilCoeffs3D(*(f[s] for f in fields)), min_size=min_size,
                pad_levels=pad_levels)
            args = (Level3Args(levels, levels[0].b)
                    if pad_levels and dev.type == "cuda" else None)
            built[dev] = (levels, args)
        out.append(built[dev])
    return out


class _MgRow3(_Row3):
    """A dp row's z-slab hierarchy: slab-local levels while a slab keeps
    two planes or more, then the gathered tail (K6 where it takes the
    cycle, else the plain torch cycle)."""

    def __init__(self, c_row, s_row, *, min_size, nu1, nu2, mg, plain):
        super().__init__(c_row, s_row)
        sharded = [c_row]
        nz_l = c_row[0].diag.shape[-3]
        while nz_l % 2 == 0 and nz_l >= 4:
            c_row = _coarsen_local(c_row)
            nz_l //= 2
            sharded.append(c_row)
        self.sharded = sharded[:-1]
        self.on_k6 = nu1 == nu2 and 1 <= nu1 <= MAX_NU3
        self.tail = _gathered_levels_3d(sharded[-1], min_size, self.on_k6)
        self.nu1, self.nu2 = nu1, nu2
        self.mg = mg
        self.plain = plain

    def _tail_cycle(self, rs):
        gathered = all_gather(rs, dim=-3)
        nz_l = rs[0].shape[-3]
        done = {}
        out = []
        for s, r_full in enumerate(gathered):
            dev = r_full.device
            if dev not in done:
                levels, args = self.tail[s]
                nz, ny, nx = r_full.shape[-3:]
                pz, py, px = levels[0].diag.shape[-3:]
                if not self.on_k6:
                    e = v_cycle_3d(levels, r_full, nu1=self.nu1,
                                   nu2=self.nu2, **self.mg)
                else:
                    rp = F.pad(r_full, (0, px - nx, 0, py - ny, 0, pz - nz))
                    if self.plain:
                        e = v_cycle3d_reference(levels, rp, nu=self.nu1,
                                                **self.mg)
                    else:
                        e = v_cycle3d(levels, rp.contiguous(), nu=self.nu1,
                                      level_args=args, **self.mg)
                done[dev] = e[..., :nz, :ny, :nx]
            out.append(done[dev][..., s * nz_l:(s + 1) * nz_l, :, :]
                       .contiguous())
        return out

    def _cycle(self, rs, level):
        if level == len(self.sharded):
            return self._tail_cycle(rs)
        c = self.sharded[level]
        e = [torch.zeros_like(r) for r in rs]
        for w in smoothing_schedule(self.mg["omega"], self.nu1):
            e = _smooth_local(c, e, rs, w)
        nbs = _neighbor_sum_local(c, e)
        r_c = [restrict_3d(r - (ci.diag * ei - nb))
               for r, ci, ei, nb in zip(rs, c, e, nbs)]
        e_c = self._cycle(r_c, level + 1)
        e = [ei + self.mg["over"] * prolong_3d(eci)
             for ei, eci in zip(e, e_c)]
        for w in reversed(smoothing_schedule(self.mg["omega"], self.nu2)):
            e = _smooth_local(c, e, rs, w)
        return e

    def precond(self, rs, live):
        del live        # no tail cycle takes a per-volume flag
        return self._cycle(rs, 0)


def sharded_solve_mgcg_3d(
    coeffs: StencilCoeffs3D,
    spec: FluxSpec3D,
    x0: torch.Tensor,
    mesh: Mesh,
    *,
    omega: float = 0.0,
    tol: float = 1e-8,
    max_iter: int = 10_000,
    check_every: int = 10_000,
    criterion: str = "residual",
    nu1: int = 1,
    nu2: int = 1,
    mg_omega: float = 0.8,
    coarse_iters: int = 32,
    min_size: int = 4,
    over: float = 1.8,
    plain: bool = False,
) -> SolveResult:
    """Multigrid-PCG over z-slabs: slab-local Galerkin coarsening while a
    slab keeps two planes or more, then a replicated tail gathered once
    per solve; halo-exchanged smoothing and
    matvec, the dots summed over the slabs, ``check_every`` clamped to 10
    as the JAX package clamps it.

    ``x0`` of shape ``(nz, ny, nx)`` solves one volume; ``(B, nz, ny,
    nx)`` also splits the batch over ``dp`` with per-volume freezing.  The
    tail is K6's whole cycle for V(nu, nu) with ``nu <= MAX_NU3`` and the
    plain torch ``v_cycle_3d`` for any other V(nu1, nu2).  ``plain=True``
    runs K6's plain version.  ``omega`` is signature parity."""
    del omega
    if nu1 < 1 or nu2 < 0:
        raise ValueError(f"V({nu1}, {nu2}): nu1 >= 1 and nu2 >= 0 required")
    mg = dict(omega=mg_omega, coarse_iters=coarse_iters, over=over)

    def make_row(c_row, s_row):
        return _MgRow3(c_row, s_row, min_size=min_size, nu1=nu1, nu2=nu2,
                       mg=mg, plain=plain)
    return _solve(coeffs, spec, x0, mesh, make_row, tol=tol,
                  max_iter=max_iter, check_every=min(check_every, 10),
                  criterion=criterion)
