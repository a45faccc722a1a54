"""The fused sharded V-cycle: K8's T1/T2 kernels on every shard of a mesh
row, one launch a leg per device (torch port of
``effectivediffusivityfvm_tpu.parallel.fused2d``).

A shard is a band of rows: with ``HALO`` rows of its neighbours on each
side, the whole pre-smoothing, residual and restriction (T1) and the
prolongation, add and post-smoothing (T2) run as one kernel each on the
shard, exact on its rows because ``nu`` sweeps and the residual invalidate
``nu + 1 < HALO`` rows at the window's edge.  The JAX engine exchanged
three strips a level (r, e after T1, and the coarse correction with ``HALO
// 2`` rows); here a shard reads them in place from its neighbours when
they share its device, and only shards on different devices exchange
strips.  The coefficient strips are exchanged once per solve
(:func:`_coef_windows`; K9 reads them, and K8 where a row spans devices).

Levels whose local block has fewer than ``HALO`` rows, or odd sizes, take
the plain-torch sharded cycle (``halo._v_cycle_sharded_2d``) from there
down.  The first coarse level whose whole grid passes ``fits_whole_cycle``
is gathered once per solve and run as one K2 cycle per device
(:func:`build_fused_tail`); where none does, the cycle ends in K2 on the
replicated hierarchy.  With every shard on one device, T1 writes its
restriction at the shard's rows of that cycle's plane and T2 reads the
correction from it.

The JAX package split a shard that was too large for VMEM into bands
(``_window_fits``, ``_banded_level``); the band changes no number (each
band's window is exact on its rows), and the card tiles a shard like any
plane, so :func:`shard_band` keeps only the structural conditions.
"""

from __future__ import annotations

from ..ops.kernels.vcycle import LevelArgs, v_cycle, v_cycle_reference
from ..ops.kernels.vcycle_sharded import (HALO, ShardRow, coef_sources,
                                          neighbour_sources, shard_row_t1,
                                          shard_row_t1_reference, shard_row_t2,
                                          shard_row_t2_reference)
from ..ops.kernels.vcycle_tiled import fits_whole_cycle
from .halo import (ShardedHierarchy, _gathered_levels, _v_cycle_sharded_2d,
                   gathered_cycle)
from .mesh import halo_strips

__all__ = ["v_cycle_sharded_fused", "fused_shard_level_ok", "shard_band",
           "build_fused_tail", "k9_coarse"]


def shard_band(ny_local: int, nx: int, itemsize: int = 4) -> int:
    """Rows the fused T1/T2 kernels take at once on a local block: the
    whole block, or 0 (no fused level: fewer than ``HALO`` rows, or odd
    sizes; such levels take the plain sweeps).  ``itemsize`` is accepted
    for signature parity."""
    del itemsize
    if ny_local < HALO or ny_local % 2 or nx % 2:
        return 0
    return ny_local


def fused_shard_level_ok(ny_local: int, nx: int, itemsize: int = 4) -> bool:
    """Whether a sharded level can run the fused T1/T2 kernels."""
    return shard_band(ny_local, nx, itemsize) > 0


def _coef_windows(sharded_levels):
    """Per fused level, per shard: ``(aw, awN, awS, an, anN, anS, dinv,
    dinvN, dinvS)``, the strips exchanged once per solve (the coefficients
    do not change); ``None`` for a level without a fused band."""
    out = []
    for c_row in sharded_levels:
        ny_l, nx = c_row[0].diag.shape[-2:]
        if not fused_shard_level_ok(ny_l, nx):
            out.append(None)
            continue
        per_shard = [[] for _ in c_row]
        for f in ("a_w", "a_n", "diag_inv"):
            planes = [getattr(c, f).contiguous() for c in c_row]
            norths, souths = halo_strips(planes, HALO)
            for s, p in enumerate(planes):
                per_shard[s].extend([p, norths[s], souths[s]])
        out.append([tuple(p) for p in per_shard])
    return out


def build_fused_tail(sharded_levels, min_size):
    """The early-gather tail: the first coarse level (from level 1) whose
    whole grid, even-padded, passes ``fits_whole_cycle``, gathered once per
    solve and coarsened with ``pad_levels=True``.  Returns ``(level,
    hierarchies per shard)``, or ``(None, None)`` when no level qualifies.
    The cycle then runs every level from there as one K2 call per device,
    each shard taking its rows."""
    n_sh = len(sharded_levels[0]) if sharded_levels else 0
    for lvl in range(1, len(sharded_levels)):
        c_row = sharded_levels[lvl]
        ny_l, nx_l = c_row[0].diag.shape[-2:]
        full = ny_l * n_sh
        if not fits_whole_cycle(full + full % 2, nx_l + nx_l % 2,
                                c_row[0].diag.element_size()):
            continue
        return lvl, _gathered_levels(c_row, min_size)
    return None, None


def _next_gathered(hier: ShardedHierarchy, tail, level):
    """The gathered hierarchies (per shard) the cycle runs from ``level +
    1``, or ``None`` when that level is sharded."""
    if tail is not None and tail[0] is not None:
        return tail[1] if tail[0] == level + 1 else None
    return hier.replicated if level + 1 == len(hier.sharded) else None


def _shard_row(hier, coef_wins, level, tail, rs):
    """K8's tables for ``level`` (:class:`ShardRow`).  The restrictions go
    straight into the gathered tail's level-0 plane when the next level is
    gathered, every shard is on one device, and that plane is the shards'
    coarse rows in order (no padding); else the tail gathers them."""
    ny_l, nx_l = rs[0].shape[-2:]
    nxt = _next_gathered(hier, tail, level)
    in_place = (nxt is not None and len({r.device for r in rs}) == 1
                and tuple(nxt[0][0].diag.shape[-2:])
                == (len(rs) * (ny_l // 2), nx_l // 2))
    row = ShardRow(coef_sources(coef_wins[level]), gathered=in_place)
    if in_place and row.device.type == "cuda":
        row.tail_args = LevelArgs(nxt[0], row.gathered)
    return row


def _tail_in_place(hier, tail, level, row, *, nu, omega, coarse_iters, over,
                   plain=False, live=None):
    """The gathered K2 tail below ``level`` on ``row.gathered`` (the
    shards' restrictions at their rows), read in place: its correction
    plane.  ``live`` (per shard, ``(B,)``) gates it: an image whose flag is
    0 gets a zero correction."""
    levels = _next_gathered(hier, tail, level)[0]
    act = None if live is None else live[0].to(row.device)
    mg = dict(omega=omega, coarse_iters=coarse_iters, over=over)
    if plain:
        return v_cycle_reference(levels, row.gathered, nu=nu, active=act,
                                 **mg)
    return v_cycle(levels, row.gathered, nu=nu, active=act,
                   level_args=row.tail_args, **mg)


def k9_coarse(hier, coef_wins, xs, *, nu, omega, coarse_iters, over,
              tail=None, plain=False, rows=None):
    """K9's coarse arguments for a row whose level-0 shards are like ``xs``
    (:func:`~..ops.kernels.cgstep_sharded.cg_steps_sharded`'s ``coarse``
    and ``coarse_plane``).  Where level 0's K8 tables restrict into the
    gathered tail's plane (every shard on one device, the next level that
    tail, no padding: :func:`_shard_row`), ``coarse_plane`` is that plane
    and ``coarse(plane, live)`` runs K2 on it in place, so that K9
    restricts into it and reads the correction from K2's output: no gather
    and no split.  Elsewhere ``coarse(rcs, live)`` runs the cycle from
    level 1 on the shards' restricted residuals.  ``rows`` is the solve's
    dict of K8 tables (:func:`v_cycle_sharded_fused`); its level-0 entry is
    made here if missing."""
    mg = dict(nu=nu, omega=omega, coarse_iters=coarse_iters, over=over,
              plain=plain)
    rows = {} if rows is None else rows

    def cycle(rcs, live):
        return v_cycle_sharded_fused(hier, coef_wins, rcs, level=1,
                                     tail=tail, live=live, rows=rows, **mg)

    if 0 not in rows:
        rows[0] = _shard_row(hier, coef_wins, 0, tail, xs)
    row = rows[0]
    if row.gathered is None:
        return dict(coarse=cycle)

    def on_plane(plane, live):
        if plane is not row.gathered:
            raise ValueError("k9_coarse: the correction is made on the "
                             "tail's own plane")
        return _tail_in_place(hier, tail, 0, row, live=live, **mg)

    return dict(coarse=on_plane, coarse_plane=row.gathered)


def v_cycle_sharded_fused(hier: ShardedHierarchy, coef_wins, rs, *, nu,
                          omega, coarse_iters, over, level=0, tail=None,
                          plain=False, live=None, rows=None):
    """The fused sharded V(nu, nu) cycle of one mesh row from ``level``:
    K8 (:func:`shard_row_t1`/:func:`shard_row_t2`, one launch a leg per
    device) on a fused level, the plain sharded sweeps on a level without a
    band, and the gathered K2 tail (``tail`` from :func:`build_fused_tail`)
    or, without one, K2 on the replicated hierarchy.  ``rs`` are the shards'
    residuals ``(B, ny_l, nx)``; returns their corrections.  A shard reads
    its neighbours' rows in place where they share its device; where the
    next level is gathered and the row on one device, T1 restricts into the
    tail's plane and T2 reads the tail's correction from it, with no gather
    or split.  ``plain=True`` runs the plain versions of every kernel.
    ``live`` (per shard, ``(B,)``) gates the gathered K2 tail: an image
    whose flag is 0 skips it (the K8 levels above the tail take no flags).
    ``rows`` (a dict the caller keeps for the solve) holds K8's tables per
    level, built on first use; without it they are built for the call."""
    mg = dict(omega=omega, coarse_iters=coarse_iters, over=over)
    if tail is not None and tail[0] is not None and level == tail[0]:
        return gathered_cycle(tail[1], rs, nu=nu, plain=plain, live=live,
                              **mg)
    if level == len(hier.sharded):
        return gathered_cycle(hier.replicated, rs, nu=nu, plain=plain,
                              live=live, **mg)
    ny_l, nx_l = rs[0].shape[-2:]
    if shard_band(ny_l, nx_l, rs[0].element_size()) == 0:
        return _v_cycle_sharded_2d(hier, rs, nu1=nu, nu2=nu, level=level,
                                   plain=plain, **mg)
    rows = {} if rows is None else rows
    if level not in rows:
        rows[level] = _shard_row(hier, coef_wins, level, tail, rs)
    row = rows[level]
    t1 = shard_row_t1_reference if plain else shard_row_t1
    t2 = shard_row_t2_reference if plain else shard_row_t2
    r_src = neighbour_sources([r.contiguous() for r in rs], HALO)
    es, rcs = t1(row, r_src, omega=omega, nu=nu)
    if row.gathered is not None:
        ec_src = _tail_in_place(hier, tail, level, row, nu=nu, plain=plain,
                                live=live, **mg)
    else:
        e_c = v_cycle_sharded_fused(hier, coef_wins, rcs, nu=nu,
                                    level=level + 1, tail=tail, plain=plain,
                                    live=live, rows=rows, **mg)
        ec_src = neighbour_sources(e_c, HALO // 2)
    return t2(row, neighbour_sources(es, HALO), r_src, ec_src, omega=omega,
              nu=nu, over=over)
