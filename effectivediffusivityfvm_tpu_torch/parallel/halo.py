"""Row-sharded 2D solves with halo exchange (torch port of the 2D part of
``effectivediffusivityfvm_tpu.parallel.halo``).

Large domains are split by rows over a mesh row's ``sp`` shards (and the
image batch over its ``dp`` rows, see :mod:`.mesh`); each damped-Jacobi
sweep exchanges a one-row strip with the two neighbouring shards, and the
Deff and residual monitors sum the shards' partials.

Correctness contract (tested): a sharded solve equals the unsharded solve
of the same system -- the same sweep count, the same Deff, fields equal to
rounding.

The "local" functions here take one mesh row: a list of per-shard tensors
``(B_l, ny_l, nx)`` (and of per-shard :class:`~..ops.fvm.StencilCoeffs`),
shard ``s`` holding rows ``[s*ny_l, (s+1)*ny_l)``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from ..ops import fvm
from ..ops.flux import BoundaryFluxSpec
from ..ops.kernels.vcycle import (MAX_NU, smoothing_schedule, v_cycle,
                                  v_cycle_reference)
from ..solvers import driver
from ..solvers.driver import SolveResult
from ..solvers.multigrid import build_hierarchy, prolong, restrict
from ..solvers.multigrid import v_cycle as plain_v_cycle
from .mesh import (Mesh, ShardedField, all_gather, gather_rows, halo_strips,
                   psum, shard_batch, shard_rows)

__all__ = ["sharded_solve_jacobi", "sharded_solve_mgcg",
           "halo_exchange_rows"]


def halo_exchange_rows(xs):
    """One-row halos of a row of shards: ``(norths, souths)``, zeros at the
    global top and bottom."""
    return halo_strips(xs, 1)


def _shifted(x, north, south):
    """``(xw, xe, xn, xs)``: the neighbour values of a shard, the north and
    south ones from its halo rows, 0 beyond the columns."""
    xn = torch.cat([north, x[..., :-1, :]], dim=-2)
    xs = torch.cat([x[..., 1:, :], south], dim=-2)
    z = torch.zeros_like(x[..., :, :1])
    xw = torch.cat([z, x[..., :, :-1]], dim=-1)
    xe = torch.cat([x[..., :, 1:], z], dim=-1)
    return xw, xe, xn, xs


def _sweep_local(c_row, xs, omega):
    """One damped-Jacobi sweep of every shard of a row."""
    norths, souths = halo_exchange_rows(xs)
    out = []
    for c, x, n, s in zip(c_row, xs, norths, souths):
        xw, xe, xn, xs_ = _shifted(x, n, s)
        num = (c.b + c.a_w * xw + c.a_e * xe + c.a_n * xn + c.a_s * xs_)
        out.append((1.0 - omega) * x + omega * num * c.diag_inv)
    return out


def _deff_local(s_row, xs):
    """Boundary-flux Deff ``(B_l,)`` of a row, the shards' flux sums added
    (on shard 0's device)."""
    ny_global = xs[0].shape[-2] * len(xs)
    acc = torch.promote_types(xs[0].dtype, torch.float32)
    parts = []
    for spec, x in zip(s_row, xs):
        cl = spec.c_left[..., None]
        cr = spec.c_right[..., None]
        ihdx = spec.inv_half_dx[..., None]
        mfl = (spec.d_left * (x[..., :, 0] - cl) * ihdx).to(acc)
        mfr = (spec.d_right * (cr - x[..., :, -1]) * ihdx).to(acc)
        parts.append(torch.sum(mfl, dim=-1) + torch.sum(mfr, dim=-1))
    q = psum(parts)[0] / (2.0 * ny_global)
    spec = s_row[0]
    denom = (spec.c_right - spec.c_left).to(acc)
    return (q / denom).to(xs[0].dtype)


def _neighbor_sum_2d_local(c_row, xs):
    """``sum_nb a_nb x_nb`` of every shard of a row (one-row exchange)."""
    norths, souths = halo_exchange_rows(xs)
    out = []
    for c, x, n, s in zip(c_row, xs, norths, souths):
        xw, xe, xn, xs_ = _shifted(x, n, s)
        out.append(c.a_w * xw + c.a_e * xe + c.a_n * xn + c.a_s * xs_)
    return out


def _resid_local(c_row, xs):
    """Mean ``|b - A x|`` ``(B_l,)`` over a row (on shard 0's device)."""
    nbs = _neighbor_sum_2d_local(c_row, xs)
    parts = [torch.sum(torch.abs(c.b - (c.diag * x - nb)), dim=(-2, -1))
             for c, x, nb in zip(c_row, xs, nbs)]
    n = xs[0].shape[-2] * xs[0].shape[-1] * len(xs)
    return psum(parts)[0] / n


class RowSystem:
    """One dp row's system as the sharded PCG drivers see it: the shards'
    coefficients ``c`` and flux specs ``s``, the matvec and the monitors.
    A subclass gives ``precond(rs, live)`` for
    :func:`.sharded_pcg.run_pcg_rows`; the 3D rows (:mod:`.halo3d`) change
    ``grid_ndim``, ``neighbor_sum`` and ``deff``."""

    grid_ndim = 2

    def __init__(self, c_row, s_row):
        self.c = c_row
        self.s = s_row
        self.npts = c_row[0].diag[0].numel() * len(c_row)

    def neighbor_sum(self, xs):
        return _neighbor_sum_2d_local(self.c, xs)

    def deff(self, xs):
        return _deff_local(self.s, xs)

    def matvec(self, xs):
        nbs = self.neighbor_sum(xs)
        return [c.diag * x - nb for c, x, nb in zip(self.c, xs, nbs)]

    # The monitors' sums accumulate in float64 and round once, as K9's and
    # the unsharded engines' reductions do.  Summed in float32 (the JAX
    # engine's psum of per-shard sums), config 3 at SP=4 took 72 iterations
    # on an H100 against the unsharded engine's 34: near the float32 floor
    # the restarts' rounding decides when relres first dips below 1e-4.
    def _sum(self, vs):
        axes = tuple(range(-self.grid_ndim, 0))
        return psum([torch.sum(v, dim=axes, dtype=torch.float64)
                     for v in vs])[0]

    def dot(self, us, vs):
        return self._sum([u * v for u, v in zip(us, vs)]).to(us[0].dtype)

    def mean_abs(self, vs):
        return (self._sum([torch.abs(v) for v in vs])
                / self.npts).to(vs[0].dtype)


# ------------------------------------------------- sharded inputs/outputs

def _place(mesh: Mesh, coeffs, spec, x0, grid_ndim: int = 2):
    """The batched inputs split over the mesh: per row, the shards'
    coefficients, flux specs and fields, split along the grid's first axis
    (rows in 2D, z in 3D).  An unbatched problem is solved by every dp row
    alike, as a batch of one."""
    batched = x0.dim() == grid_ndim + 1

    def batch(a):
        if batched:
            return a
        return a[None].expand((mesh.dp,) + tuple(a.shape))

    lead = x0.shape[-grid_ndim]
    if lead % mesh.sp:
        raise ValueError(f"the grid's first axis ({lead}) must divide SP "
                         f"({mesh.sp})")
    c_sh = [shard_rows(mesh, batch(a), row_dim=-grid_ndim) for a in coeffs]
    c_rows = [[type(coeffs)(*(f[d][s] for f in c_sh))
               for s in range(mesh.sp)] for d in range(mesh.dp)]
    faces = [shard_rows(mesh, batch(a), row_dim=1 - grid_ndim)
             for a in (spec.d_left, spec.d_right)]
    per_image = x0.shape[:-grid_ndim]
    scal = [shard_batch(mesh, batch(torch.as_tensor(a).expand(per_image)))
            for a in (spec.c_left, spec.c_right, spec.inv_half_dx)]
    s_rows = [[type(spec)(faces[0][d][s], faces[1][d][s], scal[0][d][s],
                          scal[1][d][s], scal[2][d][s])
               for s in range(mesh.sp)] for d in range(mesh.dp)]
    x_rows = shard_rows(mesh, batch(x0), row_dim=-grid_ndim)
    return batched, c_rows, s_rows, x_rows


def _unplace(batched, x_rows, vals, device, grid_ndim: int = 2):
    """Gather the result on ``device``: the global field and the per-image
    values ``(B,)``; an unbatched solve reads dp row 0."""
    x = gather_rows(x_rows if batched else x_rows[:1], device,
                    row_dim=-grid_ndim)
    if batched:
        return SolveResult(x, *vals)
    return SolveResult(x[0], *(v if v.dim() == 0 else v[0] for v in vals))


# ------------------------------------------------------------- Jacobi

def sharded_solve_jacobi(
    coeffs: fvm.StencilCoeffs,
    spec: BoundaryFluxSpec,
    x0: torch.Tensor,
    mesh: Mesh,
    *,
    omega: float = 2.0 / 3.0,
    tol: float = 1e-5,
    max_iter: int = 500_000,
    check_every: int = 10_000,
    criterion: str = "deff",
) -> SolveResult:
    """Row-sharded (and batch-sharded) Jacobi solve on ``mesh``.

    ``x0`` of shape ``(ny, nx)`` runs the single-image driver sharded over
    ``sp``; ``(B, ny, nx)`` also splits the batch over ``dp`` and keeps
    per-image convergence freezing.  One driver loop advances every shard,
    so the trip count is the same across the dp rows.  The result lies on
    ``x0``'s device."""
    omega = omega or 2.0 / 3.0
    dev = x0.device
    batched, c_rows, s_rows, x_rows = _place(mesh, coeffs, spec, x0)
    dp = mesh.dp

    def per_image(fn, x):
        vals = [fn(d, row) for d, row in enumerate(x.shards)]
        v = torch.cat([t.to(dev) for t in vals])
        return v if batched else v[0]

    def sweeps(x, k, active=None):
        rows = x.shards
        for _ in range(k):
            rows = [_sweep_local(c_rows[d], rows[d], omega)
                    for d in range(dp)]
        if active is not None:
            bl = rows[0][0].shape[0]
            kept = []
            for d in range(dp):
                a = active[d * bl:(d + 1) * bl]
                kept.append([torch.where(a.to(n.device)[:, None, None], n, o)
                             for n, o in zip(rows[d], x.shards[d])])
            rows = kept
        return x.like(rows)

    kw = dict(
        tol=tol, max_iter=max_iter, check_every=check_every,
        criterion=criterion,
        deff_fn=lambda x: per_image(lambda d, r: _deff_local(s_rows[d], r),
                                    x),
        resid_fn=lambda x: per_image(
            lambda d, r: _resid_local(c_rows[d], r), x))
    x_field = ShardedField(x_rows, x0.shape, x0.dtype, dev)
    run = driver.run_batched if batched else driver.run_single
    res = run(sweeps, coeffs, spec, x_field, **kw)
    return _unplace(batched, res.x.shards, res[1:], dev)


# ------------------------------------------------------ sharded multigrid

def _coarsen_local_2d(c_row) -> List[fvm.StencilCoeffs]:
    """Shard-local 2x2 Galerkin coarsening of a row-sharded operator.

    Same closed form as ``solvers.multigrid.coarsen`` except at the shards'
    row edges: the coupling into the next shard is carried by the local
    ``a_s`` of the last fine row (the odd-row block sum keeps it), and the
    first coarse row's ``a_n`` is the previous shard's last coarse ``a_s``
    (0 on the first shard).  Requires even local ny and nx."""
    from ..solvers.multigrid import _blocks

    parts = []
    for c in c_row:
        ae_b = _blocks(c.a_e)
        as_b = _blocks(c.a_s)
        a_e_c = ae_b[..., :, :, :, 1].sum(-2)
        a_s_c = as_b[..., :, 1, :, :].sum(-1)
        internal = ae_b[..., :, :, :, 0].sum(-2) + as_b[..., :, 0, :, :].sum(-1)
        diag_c = restrict(c.diag) - 2.0 * internal
        b_c = restrict(c.b)
        z_col = torch.zeros_like(a_e_c[..., :, :1])
        a_e_c = torch.cat([a_e_c[..., :, :-1], z_col], dim=-1)
        a_w_c = torch.cat([z_col, a_e_c[..., :, :-1]], dim=-1)
        parts.append((a_w_c, a_e_c, a_s_c, diag_c, b_c, restrict(c.diag)))
    halos, _ = halo_strips([p[2] for p in parts], 1)
    out = []
    for (a_w_c, a_e_c, a_s_c, diag_c, b_c, rdiag), halo in zip(parts, halos):
        a_n_c = torch.cat([halo, a_s_c[..., :-1, :]], dim=-2)
        floor = 1e-6 * rdiag
        ok = diag_c > floor
        diag_inv = torch.where(ok, 1.0 / torch.where(ok, diag_c, 1.0), 0.0)
        out.append(fvm.StencilCoeffs(a_w_c, a_e_c, a_n_c, a_s_c, diag_c,
                                     diag_inv, b_c))
    return out


def _smooth_local_2d(c_row, xs, bs, omega):
    """One damped-Jacobi sweep of ``A e = b`` on every shard of a row."""
    norths, souths = halo_exchange_rows(xs)
    out = []
    for c, x, b, n, s in zip(c_row, xs, bs, norths, souths):
        xw, xe, xn, xs_ = _shifted(x, n, s)
        num = (b + c.a_w * xw + c.a_e * xe + c.a_n * xn + c.a_s * xs_)
        out.append((1.0 - omega) * x + omega * num * c.diag_inv)
    return out


class ShardedHierarchy(NamedTuple):
    """One mesh row's multigrid hierarchy: ``sharded[l][s]`` the shard-local
    levels, and per shard the replicated tail built from the last local
    level gathered (``build_hierarchy``, padded for K2 or not, one
    hierarchy per device, shared by its shards)."""

    sharded: list
    replicated: list


def _gathered_levels(c_row, min_size, pad_levels=True):
    """Per shard, the hierarchy of the row's level ``c_row`` gathered,
    padded for K2 (``pad_levels``) or not; built once per device."""
    fields = [all_gather([getattr(c, f) for c in c_row])
              for f in fvm.StencilCoeffs._fields]
    built = {}
    out = []
    for s, c in enumerate(c_row):
        dev = c.diag.device
        if dev not in built:
            built[dev] = build_hierarchy(
                fvm.StencilCoeffs(*(f[s] for f in fields)),
                min_size=min_size, pad_levels=pad_levels)
        out.append(built[dev])
    return out


def _build_sharded_hierarchy_2d(c_row, ny_local, min_size=8,
                                pad_levels=True):
    """Coarsen shard-locally while the local rows stay even (and >= 4) and
    the columns even and above ``min_size``; the last local level is
    gathered and coarsened on, replicated: padded for K2's tail
    (``pad_levels``), else as the plain cycle takes it (the JAX package's
    ``build_hierarchy(gathered)``)."""
    sharded = [c_row]
    nx = c_row[0].diag.shape[-1]
    while ny_local % 2 == 0 and ny_local >= 4 and nx % 2 == 0 \
            and nx > min_size:
        c_row = _coarsen_local_2d(c_row)
        ny_local //= 2
        nx = c_row[0].diag.shape[-1]
        sharded.append(c_row)
    return ShardedHierarchy(sharded[:-1],
                            _gathered_levels(sharded[-1], min_size,
                                             pad_levels))


def gathered_on_k2(nu, nu2):
    """Whether the gathered tail of a V(nu, nu2) cycle runs on K2."""
    return nu2 == nu and 1 <= nu <= MAX_NU


def gathered_cycle(levels_per_shard, rs, *, nu, omega, coarse_iters, over,
                   nu2=None, plain=False, live=None):
    """The replicated cycle of a row: the shards' residuals gathered, one
    cycle per device, and each shard's rows sliced back out.  The cycle is
    K2 (its plain version if ``plain``) on the padded hierarchy where
    :func:`gathered_on_k2`; else (``nu2 != nu``, ``nu2=None`` being ``nu``,
    or a deeper ``nu``) the plain torch ``multigrid.v_cycle`` on the
    unpadded one, as the JAX package's tail runs.  ``live`` (optional, per
    shard an int or bool ``(B,)``): on K2, the images whose flag is 0 skip
    the cycle and get a zero correction; the plain cycle computes them and
    the PCG loop discards them."""
    nu2 = nu if nu2 is None else nu2
    on_k2 = gathered_on_k2(nu, nu2)
    cycle = v_cycle_reference if plain else v_cycle
    gathered = all_gather(rs)
    ny_l = rs[0].shape[-2]
    done = {}
    out = []
    for s, r_full in enumerate(gathered):
        dev = r_full.device
        if dev not in done:
            levels = levels_per_shard[s]
            ny_f, nx_f = r_full.shape[-2:]
            py, px = levels[0].diag.shape[-2:]
            if not on_k2:
                done[dev] = plain_v_cycle(
                    levels, r_full, nu1=nu, nu2=nu2, omega=omega,
                    coarse_iters=coarse_iters, over=over)
            else:
                rp = F.pad(r_full, (0, px - nx_f, 0, py - ny_f))
                act = None if live is None else live[s].to(dev)
                done[dev] = cycle(levels, rp.contiguous(), omega=omega,
                                  nu=nu, coarse_iters=coarse_iters,
                                  over=over, active=act)[..., :ny_f, :nx_f]
        out.append(done[dev][..., s * ny_l:(s + 1) * ny_l, :].contiguous())
    return out


def _v_cycle_sharded_2d(hier: ShardedHierarchy, rs, *, nu1=1, nu2=1,
                        omega=0.8, coarse_iters=32, over=1.8, level=0,
                        plain=False, live=None):
    """The sharded V(nu1, nu2) cycle in plain torch, a one-row exchange per
    sweep; below the local levels, :func:`gathered_cycle` on the replicated
    hierarchy (K2 where it takes the cycle; ``live`` gates it)."""
    if level == len(hier.sharded):
        return gathered_cycle(hier.replicated, rs, nu=nu1, nu2=nu2,
                              omega=omega, coarse_iters=coarse_iters,
                              over=over, plain=plain, live=live)
    c = hier.sharded[level]
    e = [torch.zeros_like(r) for r in rs]
    for w in smoothing_schedule(omega, nu1):
        e = _smooth_local_2d(c, e, rs, w)
    nbs = _neighbor_sum_2d_local(c, e)
    r_c = [restrict(r - (ci.diag * ei - nb))
           for r, ci, ei, nb in zip(rs, c, e, nbs)]
    e_c = _v_cycle_sharded_2d(hier, r_c, nu1=nu1, nu2=nu2, omega=omega,
                              coarse_iters=coarse_iters, over=over,
                              level=level + 1, plain=plain, live=live)
    e = [ei + over * prolong(eci) for ei, eci in zip(e, e_c)]
    for w in reversed(smoothing_schedule(omega, nu2)):
        e = _smooth_local_2d(c, e, rs, w)
    return e


def sharded_solve_mgcg(
    coeffs: fvm.StencilCoeffs,
    spec: BoundaryFluxSpec,
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
    min_size: int = 8,
    over: float = 1.8,
    use_pallas=None,
    first_window: int = 1,
    plain: bool = False,
) -> SolveResult:
    """Row-sharded 2D multigrid-PCG on ``mesh``: shard-local Galerkin
    coarsening, then a gathered coarse tail; equals the unsharded solve to
    rounding.

    ``x0`` of shape ``(ny, nx)`` solves one image over ``sp``; ``(B, ny,
    nx)`` also splits the batch over ``dp`` with per-image convergence
    freezing.  The engine, by the cycle and the local block alone (never
    the device):

      * the fused engine (:func:`.fused2d_cg.run_mgcg_sharded_fused`: K9's
        three passes per iteration, K8's cycle levels, K2's coarse tail)
        for V(nu, nu) with ``nu <= 4`` on a block of at least 8 even rows
        and even columns (``use_pallas`` None or True);
      * otherwise (a block that fails that test, ``use_pallas=False``,
        V(nu, nu) with ``nu > 4``, or V(nu1 != nu2)) ``run_pcg`` with the
        plain sharded cycle and its gathered tail (:mod:`.sharded_pcg`):
        K2 where it takes the cycle, V(nu, nu) with ``nu <= 8``, else the
        plain torch ``multigrid.v_cycle``, the JAX package's XLA tail.
        This is the JAX package's cycle-only engine too, since K8's band
        needs the block the fused engine needs.

    ``use_pallas=True`` runs V(nu1, nu1) whatever ``nu2``, as the JAX
    package's kernel engines do.  ``plain=True`` runs the kernels' plain
    versions.  The result lies on ``x0``'s device."""
    from ..ops.kernels.vcycle_sharded import MAX_NU
    from .fused2d_cg import run_mgcg_sharded_fused, sharded_fused_cg_ok

    del omega   # accepted for signature parity, as the JAX solver does
    if use_pallas not in (None, True, False):
        raise ValueError(f"unknown use_pallas {use_pallas!r}")
    if nu1 < 1 or nu2 < 0:
        raise ValueError(f"V({nu1}, {nu2}): nu1 >= 1 and nu2 >= 0 required")
    if use_pallas is True:
        nu2 = nu1
    ny, nx = x0.shape[-2], x0.shape[-1]
    if ny % mesh.sp:
        raise ValueError(f"image rows ({ny}) must divide SP ({mesh.sp})")
    fused_cg = (use_pallas is not False and nu1 == nu2 and nu1 <= MAX_NU
                and sharded_fused_cg_ok(ny // mesh.sp, nx, x0.element_size()))
    batched, c_rows, s_rows, x_rows = _place(mesh, coeffs, spec, x0)
    mg = dict(nu=nu1, mg_omega=mg_omega, coarse_iters=coarse_iters,
              min_size=min_size, over=over)
    if fused_cg:
        first_window = driver.resolve_first_window(first_window, check_every,
                                                   criterion)
        x_rows, deff, conv, iters = run_mgcg_sharded_fused(
            c_rows, s_rows, x_rows, tol=tol, max_iter=max_iter,
            check_every=check_every, criterion=criterion,
            first_window=first_window, plain=plain, **mg)
    else:
        from .sharded_pcg import run_mgcg_sharded_pcg

        x_rows, deff, conv, iters = run_mgcg_sharded_pcg(
            c_rows, s_rows, x_rows, batched=batched, shape=x0.shape,
            tol=tol, max_iter=max_iter, check_every=check_every,
            criterion=criterion, plain=plain, nu2=nu2, **mg)
    dev = x0.device
    return _unplace(batched, x_rows,
                    [deff.to(dev), conv.to(dev), iters.to(dev)], dev)
