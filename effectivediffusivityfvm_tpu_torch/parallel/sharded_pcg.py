"""The row-sharded MGCG modes that run under ``solvers.pcg.run_pcg`` (torch
port of ``effectivediffusivityfvm_tpu.parallel.halo``'s cycle-only and XLA
routes, ``halo.py:350-441``).

The PCG algebra is the generic engine's, on a
:class:`~.mesh.ShardedField`: one ``run_pcg`` loop over the whole mesh,
the matvec ``diag p - sum a p_nb`` with one-row halos, the dots and
``mean|r|`` summed per shard in float64 and rounded once (as the fused
engine sums them), ``check_every`` clamped to 10 as the JAX package
clamps it, and the per-image stop flags of every dp row in one ``any``.
The preconditioner is the plain sharded cycle
(:func:`~.halo._v_cycle_sharded_2d`: the shard-local sweeps with one-row
halos, then K2 on the gathered tail, or the plain torch cycle there for
V(nu1 != nu2) and a ``nu`` past K2's).  It serves every mode the fused
engine does not take: the JAX package's cycle-only engine, for a local
block that fails ``sharded_fused_cg_ok`` (odd rows, or fewer than
``HALO``), and its XLA route, for ``use_pallas=False``, V(nu, nu) past
K8's ``nu`` and V(nu1 != nu2).  K8 cannot serve the first: its band
needs the same even block of ``HALO`` rows or more that the fused engine
needs, so on such a block the cycle-only engine is this cycle, and a block
of odd rows has no sharded level at all (the cycle is the gathered tail on
the whole image).

The gathered K2 tail skips a frozen image (its ``live`` flag).
"""

from __future__ import annotations

import torch

from .halo import (RowSystem, _build_sharded_hierarchy_2d,
                   _v_cycle_sharded_2d, gathered_on_k2)
from .mesh import ShardedField
from ..solvers.pcg import run_pcg

__all__ = ["run_pcg_rows", "run_mgcg_sharded_pcg"]


def run_pcg_rows(rows, x_rows, *, shape, batched, **kw):
    """``run_pcg`` on a sharded field: ``rows[d]`` is dp row ``d``'s
    :class:`~.halo.RowSystem` (its matvec, float64 monitors and
    ``precond(rs, live)``; ``live`` per shard the ``(B_l,)`` active flags,
    or ``None``), ``x_rows[d][s]`` the start's shards of the global
    ``shape``; ``kw`` the engine's other arguments.  With ``batched=False``
    the rows hold one image each (pass dp row 0 alone).  The per-image
    values lie on shard (0, 0)'s device."""
    x0 = x_rows[0][0]
    dev = x0.device
    field = ShardedField(x_rows, shape, x0.dtype, dev)

    def per_image(vals):
        v = torch.cat([t.to(dev) for t in vals])
        return v if batched else v[0]

    def each(fn, *fields):
        return [fn(row, *(f.shards[d] for f in fields))
                for d, row in enumerate(rows)]

    def precond(r, active=None):
        out = []
        for d, (row, rs) in enumerate(zip(rows, r.shards)):
            live = (None if active is None
                    else [field.part(active, d, x.device) for x in rs])
            out.append(row.precond(rs, live))
        return field.like(out)

    sys = type(rows[0])
    return run_pcg(
        matvec=lambda p: field.like(each(sys.matvec, p)),
        precond=precond,
        b=field.like([[c.b for c in row.c] for row in rows]),
        x0=field,
        deff_fn=lambda x: per_image(each(sys.deff, x)),
        grid_ndim=sys.grid_ndim, batched=batched,
        mean_abs_fn=lambda u: per_image(each(sys.mean_abs, u)),
        dot_fn=lambda u, v: per_image(each(sys.dot, u, v)), **kw)


class _PcgRow(RowSystem):
    """One dp row's system and its cycle."""

    def __init__(self, c_row, s_row, *, min_size, mg, nu, nu2, plain):
        super().__init__(c_row, s_row)
        self.hier = _build_sharded_hierarchy_2d(
            c_row, c_row[0].diag.shape[-2], min_size=min_size,
            pad_levels=gathered_on_k2(nu, nu2))
        self.kw = dict(nu1=nu, nu2=nu2, plain=plain, **mg)

    def precond(self, rs, live):
        return _v_cycle_sharded_2d(self.hier, rs, live=live, **self.kw)


def run_mgcg_sharded_pcg(c_rows, s_rows, x_rows, *, batched, shape, tol,
                         max_iter, check_every, criterion, nu, mg_omega,
                         coarse_iters, min_size, over, nu2=None, plain=False):
    """Sharded V(nu, nu2) MGCG under ``run_pcg`` (``nu2=None`` is ``nu``)
    over the mesh rows ``c_rows[d][s]``, ``s_rows`` and ``x_rows``
    (``(B_l, ny_l, nx)`` shards of the global ``shape``).  ``batched=False`` solves one image on dp row 0 (every row
    holds it).  Returns ``(x_rows, deff, conv, iters)``, the per-image
    values on shard (0, 0)'s device.  ``plain=True`` runs the kernels'
    plain versions."""
    if not batched:
        c_rows, s_rows, x_rows = c_rows[:1], s_rows[:1], x_rows[:1]
    mg = dict(omega=mg_omega, coarse_iters=coarse_iters, over=over)
    nu2 = nu if nu2 is None else nu2
    rows = [_PcgRow(c, s, min_size=min_size, mg=mg, nu=nu, nu2=nu2,
                    plain=plain) for c, s in zip(c_rows, s_rows)]
    res = run_pcg_rows(rows, x_rows, shape=shape, batched=batched, tol=tol,
                       max_iter=max_iter, check_every=min(check_every, 10),
                       criterion=criterion)
    return res.x.shards, res.deff, res.conv, res.iters
