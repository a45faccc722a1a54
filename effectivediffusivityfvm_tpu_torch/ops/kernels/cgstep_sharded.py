"""K9: up to ``k`` multigrid-preconditioned CG iterations per image on a row
of shards, each iteration three passes per shard with the per-image scalars
summed over the shards between them -- the CUDA kernels
(``csrc/cgstep_sharded.cu`` over ``csrc/tiled.cuh`` and
``csrc/cgscalars.cuh``) driven by a host loop, and its plain PyTorch
version.

Replaces ``effectivediffusivityfvm_tpu/parallel/fused2d_cg.py``
(``_cg_steps_sharded``: ``_pa_cg``, ``_pb_cg``, ``_pc_cg``; and the banded
``_cg_steps_sharded_banded``).  The contract per image, for the shards
``xs[s]`` of one dp group (rows ``[s*ny_l, (s+1)*ny_l)`` of the image):

* ``active <= 0``: frozen -- nothing changes and ``k_done = 0``;
* ``live = active > 0 and stop < sum|r_in| < hi`` (sums over all shards);
  for ``k`` iterations, while live: ``beta = rz/rz_prev`` (0 at ``i = 0``
  or if ``rz_prev <= 0``), ``p = z + beta p`` (``z = p`` on entry), ``q =
  A p``, ``alpha = rz/<p,q>`` (0 unless ``<p,q> > 0``), ``x += alpha p``,
  ``r -= alpha q``, ``z`` = the sharded cycle of ``r`` (T1 of K8's kind
  fused into pass B, the caller's ``coarse`` on the restricted residual,
  T2 fused into pass C), ``rz = <r, z>``, ``k_done += 1``, ``live = stop <
  sum|r| < hi``;
* the window ends after the iteration in which the last image died (the
  JAX loop's ``(i < k) & reduce_any(live)``), so a dead iteration costs
  nothing; ``coarse(rcs, live)`` gets the per-shard live flags and skips
  the images whose flag is 0;
* no refresh: the caller refreshes between windows.

``A`` is level 0's stencil with the diagonal rebuilt as ``1/diag_inv``.
Each shard's window reads its neighbours' rows from ``HALO``-row strips,
exchanged after the pass that writes a plane: p after pass A (a fifth
exchange rather than the TPU engine's pointwise strip update: with the same
beta the copy is the same numbers), r and e after pass B, the coarse
correction (``HALO // 2`` rows) before pass C and z after it.  The
coefficient strips come from the caller (exchanged once per solve).  Both
versions update x, r and p in place and return them.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ...parallel.mesh import halo_strips
from ..fvm import guarded_inverse
from .vcycle import _CTYPE, _nbsum, check_plane, smoothing_schedule, weights
from .vcycle_sharded import (HALO, MAX_NU, check_coarse, check_shard,
                             pointers, window)
from .vcycle_tiled import post_reference, pre_reference

__all__ = ["cg_steps_sharded_reference", "cg_steps_sharded"]


def _dsum(v):
    """Per-image sum over the grid in float64 (not rounded)."""
    return torch.sum(v, dim=tuple(range(1, v.dim())), dtype=torch.float64)


def _shard_sum(parts, dev, dtype):
    """Sum per-shard float64 partials in shard order, rounded once."""
    tot = parts[0].to(dev)
    for v in parts[1:]:
        tot = tot + v.to(dev)
    return tot.to(dtype)


def cg_steps_sharded_reference(coefs, xs, rs, ps, rz, active, stop, hi,
                               k: int, *, coarse: Callable, omega, nu: int,
                               over: float):
    """Plain PyTorch version of :func:`cg_steps_sharded` (same arguments,
    same outputs, same in-place update of the x/r/p shards)."""
    ws = smoothing_schedule(omega, nu)
    dev0, dt = xs[0].device, xs[0].dtype
    ny = xs[0].shape[-2]
    n = len(xs)
    wins = [tuple(window(*c[i:i + 3]) for i in (0, 3, 6)) for c in coefs]
    dgs = [guarded_inverse(w[2]) for w in wins]

    def body(a):
        return a[..., HALO:HALO + ny, :]

    def on(v, s):
        return v.to(xs[s].device)[:, None, None]

    x, r, p = list(xs), list(rs), list(ps)
    stop, hi = stop.to(dt), hi.to(dt)
    rz_c = rz.to(dt).clone()
    rz_p = rz_c.clone()
    sr = _shard_sum([_dsum(torch.abs(v)) for v in r], dev0, dt)
    live = (active > 0) & (sr > stop) & (sr < hi)
    k_done = torch.zeros(x[0].shape[0], dtype=torch.int32, device=dev0)
    z = p
    for i in range(k):
        if not bool(live.any()):
            break
        beta = torch.where(live & (rz_p > 0) & (i > 0),
                           rz_c / torch.where(rz_p > 0, rz_p, 1.0), 0.0)
        zn, zs = halo_strips(z, HALO)
        pn, pss = halo_strips(p, HALO)
        p_new, paps = [], []
        for s in range(n):
            aw, an, _ = wins[s]
            pw = window(z[s], zn[s], zs[s]) + on(beta, s) * window(
                p[s], pn[s], pss[s])
            q = dgs[s] * pw - _nbsum(aw, an, pw)
            paps.append(_dsum(body(pw) * body(q)))
            p_new.append(torch.where(on(live, s), body(pw), p[s]))
        pap = _shard_sum(paps, dev0, dt)
        alpha = torch.where(live & (pap > 0),
                            rz_c / torch.where(pap > 0, pap, 1.0), 0.0)
        pn, pss = halo_strips(p_new, HALO)
        rn, rss = halo_strips(r, HALO)
        r_new, es, rcs, srs = [], [], [], []
        for s in range(n):
            aw, an, _ = wins[s]
            lv, a3 = on(live, s), on(alpha, s)
            pw = window(p_new[s], pn[s], pss[s])
            q = dgs[s] * pw - _nbsum(aw, an, pw)
            rw = window(r[s], rn[s], rss[s]) - a3 * q
            x[s] = torch.where(lv, x[s] + a3 * p_new[s], x[s])
            srs.append(_dsum(torch.abs(body(rw))))
            e, rc = pre_reference(wins[s], rw, ws)
            r_new.append(torch.where(lv, body(rw), r[s]))
            es.append(torch.where(lv, body(e), 0.0))
            rcs.append(torch.where(
                lv, rc[..., HALO // 2:HALO // 2 + ny // 2, :], 0.0))
        ecs = coarse(rcs, [live] * n)
        en, ess = halo_strips(es, HALO)
        rn, rss = halo_strips(r_new, HALO)
        ecn, ecss = halo_strips(ecs, HALO // 2)
        z_new, rzs = [], []
        for s in range(n):
            zw = post_reference(wins[s], window(es[s], en[s], ess[s]),
                                window(r_new[s], rn[s], rss[s]),
                                window(ecs[s], ecn[s], ecss[s]), ws, over)
            rzs.append(_dsum(r_new[s] * body(zw)))
            z_new.append(torch.where(on(live, s), body(zw), z[s]))
        rz_out = _shard_sum(rzs, dev0, dt)
        sr_out = _shard_sum(srs, dev0, dt)
        sr = torch.where(live, sr_out, sr)
        rz_p = torch.where(live, rz_c, rz_p)
        rz_c = torch.where(live, rz_out, rz_c)
        k_done = k_done + live.to(torch.int32)
        live = live & (sr > stop) & (sr < hi)
        p, r, z = p_new, r_new, z_new
    for s in range(n):
        xs[s].copy_(x[s])
        rs[s].copy_(r[s])
        ps[s].copy_(p[s])
    return xs, rs, ps, rz_c, k_done


class _DeviceState:
    """The per-image scalars and partial buffers of the shards on one
    device (every device holding shards of the row keeps its own copy)."""

    def __init__(self, bsz, ntot, dt, dev, rz, stop, hi, active):
        f = dict(dtype=dt, device=dev)
        i = dict(dtype=torch.int32, device=dev)
        self.rz = rz.to(**f).clone()
        self.rz_prev = torch.empty(bsz, **f)
        self.alpha = torch.zeros(bsz, **f)
        self.stop = stop.to(**f).contiguous()
        self.hi = hi.to(**f).contiguous()
        self.active = active.to(**f).contiguous()
        self.live = torch.empty(bsz, **i)
        self.par = torch.empty(bsz, **i)
        self.k_done = torch.empty(bsz, **i)
        d = dict(dtype=torch.float64, device=dev)
        self.parts = [torch.zeros(bsz * ntot, **d) for _ in range(3)]
        self.ptrs = pointers([self.rz, self.rz_prev, self.alpha, self.stop,
                              self.hi, self.live, self.par, self.k_done,
                              *self.parts])
        with torch.cuda.device(dev):
            self.stream = torch.cuda.current_stream().cuda_stream


def cg_steps_sharded(coefs: Sequence, xs: List[torch.Tensor],
                     rs: List[torch.Tensor], ps: List[torch.Tensor], rz,
                     active, stop, hi, k: int, *, coarse: Callable, omega,
                     nu: int, over: float):
    """Run up to ``k`` sharded MGCG iterations on one dp group's shards.

    Args:
      coefs: per shard, level 0's ``(aw, awN, awS, an, anN, anS, dinv,
        dinvN, dinvS)`` (bodies ``(B, ny_l, nx)``, strips ``(B, HALO, nx)``).
      xs, rs, ps: per shard, the CG state ``(B, ny_l, nx)``, updated in
        place; shard ``s`` on its own device.
      rz, active, stop, hi: per image ``(B,)`` on shard 0's device: ``<r,
        z>``, ``> 0`` iterates / ``<= 0`` frozen, and the early-exit and
        divergence thresholds on ``sum|r|`` over all shards.
      k: iteration cap (host integer).
      coarse: ``coarse(rcs, live)`` maps the shards' restricted residuals
        ``(B, ny_l/2, nx/2)`` to their coarse corrections (the cycle from
        level 1); ``live`` holds each shard's per-image flags on its device
        (the images whose flag is 0 may skip the cycle: their corrections
        are not read).
    Returns:
      ``(xs, rs, ps, rz, k_done)``; ``k_done`` is int32 ``(B,)`` on shard
      0's device.

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (float32 or float64, ``nu <= 4``) or raise.  The host reads ``any(live)``
    once before each iteration (one synchronisation, against the ~1 ms of
    launches, exchanges and coarse tail that a dead iteration would cost)
    and ends the window when no image is live.
    """
    if nu < 1 or nu > MAX_NU:
        raise ValueError(f"cg_steps_sharded: nu={nu} must be in 1..{MAX_NU}")
    kw = dict(coarse=coarse, omega=omega, nu=nu, over=over)
    if xs[0].device.type == "cpu":
        return cg_steps_sharded_reference(coefs, xs, rs, ps, rz, active, stop,
                                          hi, k, **kw)
    if xs[0].device.type != "cuda":
        raise ValueError(f"cg_steps_sharded: unsupported device "
                         f"{xs[0].device}")
    from ._build import check, load_library

    n = len(xs)
    for s in range(n):
        like = xs[s]
        if like.device.type != "cuda":
            raise ValueError(f"cg_steps_sharded: shard {s} on {like.device}")
        check_shard(tuple(coefs[s]), like, f"cg_steps_sharded shard {s}")
        for nm, t in (("r", rs[s]), ("p", ps[s])):
            check_plane(t, f"{nm}[{s}]", like.shape, like)
        if like.shape != xs[0].shape or like.dtype != xs[0].dtype:
            raise ValueError("cg_steps_sharded: shards differ in shape/dtype")
    lib = load_library()
    bsz, ny, nx = xs[0].shape
    dt = xs[0].dtype
    sfx = _CTYPE[dt]
    nt = lib.deff_shard_tiles(ny, nx)
    ntot = n * nt
    for name, t in (("rz", rz), ("active", active), ("stop", stop),
                    ("hi", hi)):
        if tuple(t.shape) != (bsz,):
            raise ValueError(f"cg_steps_sharded: {name} shape "
                             f"{tuple(t.shape)}, expected ({bsz},)")
    states = {}
    for x in xs:
        if x.device not in states:
            states[x.device] = _DeviceState(bsz, ntot, dt, x.device, rz, stop,
                                            hi, active)
    st = [states[x.device] for x in xs]
    ws = weights(omega, nu)

    def scratch(rows, cols):
        return [x.new_zeros((bsz, rows, cols)) for x in xs]

    P = [list(ps), [torch.empty_like(x) for x in xs]]
    R = [list(rs), [torch.empty_like(x) for x in xs]]
    zbuf = [torch.empty_like(x) for x in xs]
    ebuf = [torch.empty_like(x) for x in xs]
    rcbuf = [x.new_empty((bsz, ny // 2, nx // 2)) for x in xs]
    strips = {nm: (scratch(HALO, nx), scratch(HALO, nx))
              for nm in ("p", "r", "e", "z")}
    ecs_strips = (scratch(HALO // 2, nx // 2), scratch(HALO // 2, nx // 2))

    def exchange(nm, planes):
        halo_strips(planes, HALO, out=strips[nm])

    def rows(nm, planes, s):
        north, south = strips[nm]
        return (planes[s], north[s], south[s])

    def sync_parts(which):
        """Copy each shard's partial slots to every other device."""
        if len(states) == 1:
            return
        for s in range(n):
            for dst in states.values():
                if dst is st[s]:
                    continue
                dst.parts[which].view(bsz, n, nt)[:, s].copy_(
                    st[s].parts[which].view(bsz, n, nt)[:, s])

    def fin(kind):
        for sd in states.values():
            check(getattr(lib, f"deff_shard_fin_{sfx}")(
                kind, bsz, sd.ptrs, ntot, sd.active.data_ptr(), sd.stream),
                "cg_steps_sharded (finalize)")

    exchange("p", P[0])
    exchange("r", R[0])
    for s in range(n):
        check(getattr(lib, f"deff_shard_abs_parts_{sfx}")(
            bsz, ny, nx, R[0][s].data_ptr(), st[s].parts[1].data_ptr(), ntot,
            s * nt, st[s].stream), "cg_steps_sharded (sum|r|)")
    sync_parts(1)
    fin(0)
    pass_a = getattr(lib, f"deff_shard_pass_a_{sfx}")
    pass_b = getattr(lib, f"deff_shard_pass_b_{sfx}")
    pass_c = getattr(lib, f"deff_shard_pass_c_{sfx}")
    ran = 0
    for i in range(k):
        if not bool(st[0].live.any()):
            break
        ran += 1
        cur, nxt = i % 2, 1 - i % 2
        znm, zsrc = ("p", P[cur]) if i == 0 else ("z", zbuf)
        for s in range(n):
            planes = pointers(tuple(coefs[s]) + rows(znm, zsrc, s)
                              + rows("p", P[cur], s))
            check(pass_a(bsz, ny, nx, HALO, planes, P[nxt][s].data_ptr(),
                         1 if i == 0 else 0, st[s].ptrs, ntot, s * nt, nu,
                         st[s].stream), "cg_steps_sharded (pass A)")
        exchange("p", P[nxt])
        sync_parts(0)
        fin(1)
        for s in range(n):
            planes = pointers(tuple(coefs[s]) + rows("p", P[nxt], s)
                              + rows("r", R[cur], s))
            check(pass_b(bsz, ny, nx, HALO, planes, xs[s].data_ptr(),
                         R[nxt][s].data_ptr(), ebuf[s].data_ptr(),
                         rcbuf[s].data_ptr(), st[s].ptrs, ntot, s * nt, ws,
                         nu, st[s].stream), "cg_steps_sharded (pass B)")
        exchange("r", R[nxt])
        exchange("e", ebuf)
        ecs = coarse(rcbuf, [sd.live for sd in st])
        ecn, ecss = halo_strips(ecs, HALO // 2, out=ecs_strips)
        for s in range(n):
            if i == 0:
                check_coarse(ecs[s], ecn[s], ecss[s], xs[s],
                             "cg_steps_sharded")
            planes = pointers(tuple(coefs[s]) + rows("e", ebuf, s)
                              + rows("r", R[nxt], s)
                              + (ecs[s], ecn[s], ecss[s]))
            check(pass_c(bsz, ny, nx, HALO, planes, zbuf[s].data_ptr(),
                         float(over), st[s].ptrs, ntot, s * nt, ws, nu,
                         st[s].stream), "cg_steps_sharded (pass C)")
        exchange("z", zbuf)
        sync_parts(1)
        sync_parts(2)
        fin(2)
    if ran % 2:                         # the last iteration wrote P[1], R[1]
        for s in range(n):
            ps[s].copy_(P[1][s])
            rs[s].copy_(R[1][s])
    cg_steps_sharded.launches += 1
    return xs, rs, ps, st[0].rz, st[0].k_done


cg_steps_sharded.launches = 0
