"""The fused sharded MGCG engine: K9's three passes per PCG iteration on
every shard, K8's sharded cycle levels below them, and the outer driver
with checks, refresh and the divergence net (torch port of
``effectivediffusivityfvm_tpu.parallel.fused2d_cg``).

One iteration (``ops/kernels/cgstep_sharded.py``): pass P (``p = z + beta
p``, ``q = A p``, partial ``<p, q>``), the per-image sum over the shards and
alpha, pass X (``x``, ``r`` and T1), the coarse levels from level 1
(:func:`.fused2d.k9_coarse`: K2 on the gathered tail's plane in place, or
:func:`.fused2d.v_cycle_sharded_fused`), pass Z (T2 and partial ``<r,
z>``), beta.  Every shard of an image reads the same sums, so the shards
stay in lockstep.

The driver is the sharded twin of ``solvers.multigrid._run_mgcg_fused``:
windows of ``first_window`` then ``check_every`` iterations, cut by
``max_iter`` (a cut window still checks); after each window a true-residual
refresh and CG restart of every active image at a check; the best iterate
kept and returned where the divergence net fired; the monitors summed over
the shards; one ``any(active)`` read-back per window for the whole mesh.
"""

from __future__ import annotations

import torch

from ..ops.kernels.cgstep_sharded import (ShardWorkspace, cg_steps_sharded,
                                          cg_steps_sharded_reference)
from ..ops.kernels.vcycle_sharded import HALO
from .fused2d import (_coef_windows, build_fused_tail, k9_coarse,
                      shard_band, v_cycle_sharded_fused)
from .halo import RowSystem, _build_sharded_hierarchy_2d

__all__ = ["run_mgcg_sharded_fused", "sharded_fused_cg_ok"]


def sharded_fused_cg_ok(ny_local: int, nx: int, itemsize: int = 4) -> bool:
    """Whether the fused engine can run on a local block: even sizes and at
    least ``HALO`` rows."""
    band = shard_band(ny_local, nx, itemsize)
    return band >= HALO and band % 2 == 0 and ny_local >= HALO


class _Row(RowSystem):
    """One dp row's system: the sharded hierarchy, the coefficient strips,
    the tail and the monitors."""

    def __init__(self, c_row, s_row, *, min_size, mg, nu, plain):
        super().__init__(c_row, s_row)
        self.hier = _build_sharded_hierarchy_2d(
            c_row, c_row[0].diag.shape[-2], min_size=min_size)
        self.coef_wins = _coef_windows(self.hier.sharded)
        self.tail = build_fused_tail(self.hier.sharded, min_size)
        self.kw = dict(nu=nu, tail=self.tail, plain=plain, **mg)
        self.k9 = None          # K9's workspace, kept for the whole solve
        self.k9_kw = None       # K9's coarse arguments, likewise
        self.k8 = {}            # K8's tables per level, likewise

    def cg_kwargs(self, xs):
        """The keywords of K9's windows: its coarse arguments
        (:func:`.fused2d.k9_coarse`: the gathered tail's plane restricted
        into and read in place where it can be) and, on a card, the solve's
        workspace (its buffers and graphs live as long as the solve)."""
        if self.k9_kw is None:
            self.k9_kw = k9_coarse(self.hier, self.coef_wins, xs,
                                   rows=self.k8, **self.kw)
        if self.kw["plain"] or xs[0].device.type != "cuda":
            return dict(self.k9_kw)
        if self.k9 is None:
            self.k9 = ShardWorkspace(
                self.coef_wins[0], xs,
                coarse_plane=self.k9_kw.get("coarse_plane"))
        return dict(self.k9_kw, workspace=self.k9)

    def cycle(self, rs, level=0, live=None):
        return v_cycle_sharded_fused(self.hier, self.coef_wins, rs,
                                     level=level, live=live, rows=self.k8,
                                     **self.kw)

    def fresh(self, xs):
        r = [c.b - a for c, a in zip(self.c, self.matvec(xs))]
        z = self.cycle(r)
        return r, z, self.dot(r, z)


def run_mgcg_sharded_fused(c_rows, s_rows, x_rows, *, tol, max_iter,
                           check_every, criterion, nu, mg_omega, coarse_iters,
                           min_size, over, first_window=1, plain=False):
    """Sharded MGCG on the fused engine over the mesh rows ``c_rows[d][s]``
    (per-shard coefficients), ``s_rows`` (flux specs) and ``x_rows``
    (fields ``(B_l, ny_l, nx)``).  Returns ``(x_rows, deff, conv, iters)``,
    the per-image values ``(B,)`` on shard (0, 0)'s device.  The caller
    (``halo.sharded_solve_mgcg``) owns the mesh and the engine guard
    (:func:`sharded_fused_cg_ok`)."""
    mg = dict(omega=mg_omega, coarse_iters=coarse_iters, over=over)
    rows = [_Row(c, s, min_size=min_size, mg=mg, nu=nu, plain=plain)
            for c, s in zip(c_rows, s_rows)]
    cg_fn = cg_steps_sharded_reference if plain else cg_steps_sharded
    dev = x_rows[0][0].device
    dtype = x_rows[0][0].dtype
    bl = x_rows[0][0].shape[0]
    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    npts = torch.tensor(rows[0].npts, dtype=dtype, device=dev)

    def cat(vals):
        return torch.cat([v.to(dev) for v in vals])

    def part(v, d):
        return v[d * bl:(d + 1) * bl].to(x_rows[d][0].device)

    def where_rows(m, a, b):
        return [[torch.where(part(m, d).to(u.device)[:, None, None], u, w)
                 for u, w in zip(a[d], b[d])] for d in range(len(rows))]

    def mean_abs(v_rows):
        return cat([row.mean_abs(v) for row, v in zip(rows, v_rows)])

    def deff_fn(x_rows):
        return cat([row.deff(x) for row, x in zip(rows, x_rows)])

    def fresh(x_rows):
        out = [row.fresh(x) for row, x in zip(rows, x_rows)]
        return [o[0] for o in out], [o[1] for o in out], cat([o[2]
                                                             for o in out])

    bsz = bl * len(rows)
    bscale = (mean_abs([[c.b for c in row.c] for row in rows])
              if criterion == "relresidual" else None)
    if criterion == "residual":
        stop_sum = torch.full((bsz,), tol, dtype=dtype, device=dev) * npts
    elif criterion == "relresidual":
        stop_sum = tol_ * bscale * npts
    else:
        stop_sum = torch.zeros((bsz,), dtype=dtype, device=dev)

    def scal(v):
        return torch.full((bsz,), v, dtype=dtype, device=dev)

    # x is updated in place by the kernels: start from private copies
    x = [[t.clone() for t in row] for row in x_rows]
    r, p, rz = fresh(x)
    deff, deff_old, pc, conv = scal(1.0), scal(5.0), scal(100.0), scal(100.0)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    x_best = [[t.clone() for t in row] for row in x]
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
        rz_rows, kd_rows = [], []
        for d, row in enumerate(rows):
            out = cg_fn([c for c in row.coef_wins[0]], x[d], r[d], p[d],
                        part(rz, d), part(active.to(dtype), d),
                        part(stop_sum, d), part(hi_sum, d), k,
                        omega=mg_omega, nu=nu, over=over,
                        **row.cg_kwargs(x[d]))
            x[d], r[d], p[d] = out[0], out[1], out[2]
            rz_rows.append(out[3])
            kd_rows.append(out[4])
        rz, kdone = cat(rz_rows), cat(kd_rows)
        it += k
        iters = iters + torch.where(active, kdone, 0)
        # a window cut by max_iter lands a check all the same
        do_check = ((it - first_window) % check_every == 0) or it >= max_iter
        upd = active & do_check
        r_true, z_true, rz_true = fresh(x)
        r = where_rows(upd, r_true, r)
        p = where_rows(upd, z_true, p)
        rz = torch.where(upd, rz_true, rz)
        r_mean = mean_abs(r_true)
        improved = upd & (r_mean < best)
        x_best = where_rows(improved, x, x_best)
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
    x_out = where_rows(bad, x_best, x)
    deff_out = deff_fn(x_out)
    if criterion == "relresidual":
        conv = torch.where(bad, best / bscale, conv)
    elif criterion != "deff":
        conv = torch.where(bad, best, conv)
    return x_out, deff_out, conv, iters
