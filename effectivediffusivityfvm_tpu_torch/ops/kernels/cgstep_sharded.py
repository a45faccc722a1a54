"""K9: up to ``k`` multigrid-preconditioned CG iterations per image on a row
of shards, each iteration three passes with the per-image scalars summed
over the shards between them -- the CUDA kernels (``csrc/cgstep_sharded.cu``
over ``csrc/tile2d.cuh`` and ``csrc/cgscalars.cuh``: one launch a pass for
all the shards of the row on a device), replayed from CUDA graphs when the
shards share a device and launched from a host loop when they do not, and
its plain PyTorch version.

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
  fused into pass X, the caller's ``coarse`` on the restricted residual,
  T2 fused into pass Z), ``rz = <r, z>``, ``k_done += 1``, ``live = stop <
  sum|r| < hi``;
* the window ends after the iteration in which the last image died (the
  JAX loop's ``(i < k) & reduce_any(live)``): the plain version and the
  host loop leave it there, the graph route at most :data:`WINDOW_LAG`
  gated iterations later; ``coarse`` gets the per-shard live flags and
  skips the images whose flag is 0;
* no refresh: the caller refreshes between windows.

``A`` is level 0's stencil with the diagonal rebuilt as ``1/diag_inv``.
A shard's window reads the rows next to it from its neighbours: in place
where they share its device, from ``HALO``-row strips where they do not
(exchanged after the pass that writes a plane: p and q after pass P, r and
e after pass X, the coarse correction (``HALO // 2`` rows) before pass Z
and z after it); the coefficient strips come from the caller (exchanged
once per solve).  With ``coarse_plane`` (the gathered coarse tail's level-0
plane on the shards' one device, ``(B, S ny_l/2, nx/2)``) each shard's
restriction lands at its rows of the plane, ``coarse(coarse_plane, live)``
returns the correction as one plane of that shape, and pass Z reads it in
place: no gather and no split.  Both versions update x, r and p in place
and return them.
"""

from __future__ import annotations

import ctypes
import inspect
import weakref
from typing import Callable, List, Sequence

import torch

from ...parallel.mesh import halo_strips
from ..fvm import guarded_inverse
from .cgstep import WINDOW_LAG
from .vcycle import _CTYPE, _nbsum, check_plane, smoothing_schedule, weights
from .vcycle_sharded import (HALO, MAX_NU, _put, _put_gathered, check_shard,
                             coef_sources, pointers, window)
from .vcycle_tiled import post_reference, pre_reference

__all__ = ["cg_steps_sharded_reference", "cg_steps_sharded",
           "ShardWorkspace", "WINDOW_LAG"]

# per shard of a launch, the slots of each pass's table
# (csrc/cgstep_sharded.cu): staged planes three slots each, outputs one
P_SLOTS = 17        # a_w, a_n, diag_inv, z, p_old; p, q
X_SLOTS = 20        # a_w, a_n, diag_inv, r_old, q; p, x, r, e, rc
Z_SLOTS = 19        # a_w, a_n, diag_inv, e, r_new, e_c; z


def _dsum(v):
    """Per-image sum over the grid in float64 (not rounded)."""
    return torch.sum(v, dim=tuple(range(1, v.dim())), dtype=torch.float64)


def _shard_sum(parts, dev, dtype):
    """Sum per-shard float64 partials in shard order, rounded once."""
    tot = parts[0].to(dev)
    for v in parts[1:]:
        tot = tot + v.to(dev)
    return tot.to(dtype)


def _check_coarse_plane(plane, xs, what):
    """The gathered coarse plane: ``(B, S ny_l/2, nx/2)`` on the shards'
    one device."""
    bsz, ny, nx = xs[0].shape
    if len({x.device for x in xs}) != 1:
        raise ValueError(f"{what}: coarse_plane needs every shard on one "
                         "device")
    check_plane(plane, f"{what} coarse_plane",
                (bsz, len(xs) * (ny // 2), nx // 2), xs[0])


def cg_steps_sharded_reference(coefs, xs, rs, ps, rz, active, stop, hi,
                               k: int, *, coarse: Callable, omega, nu: int,
                               over: float, coarse_plane=None):
    """Plain PyTorch version of :func:`cg_steps_sharded` (same arguments,
    same outputs, same in-place update of the x/r/p shards; with
    ``coarse_plane`` the restrictions are written into it and
    ``coarse(coarse_plane, live)`` gives the correction plane)."""
    ws = smoothing_schedule(omega, nu)
    dev0, dt = xs[0].device, xs[0].dtype
    ny = xs[0].shape[-2]
    n = len(xs)
    if coarse_plane is not None:
        _check_coarse_plane(coarse_plane, xs, "cg_steps_sharded_reference")
    wins = [tuple(window(*c[i:i + 3]) for i in (0, 3, 6)) for c in coefs]
    dgs = [guarded_inverse(w[2]) for w in wins]

    def body(a):
        return a[..., HALO:HALO + ny, :]

    def on(v, s):
        return v.to(xs[s].device)[:, None, None]

    def rows_c(plane, s):
        return plane[..., s * (ny // 2):(s + 1) * (ny // 2), :]

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
        if coarse_plane is None:
            ecs = coarse(rcs, [live] * n)
        else:
            for s in range(n):
                rows_c(coarse_plane, s).copy_(rcs[s])
            ec = coarse(coarse_plane, [live] * n)
            ecs = [rows_c(ec, s) for s in range(n)]
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

    def __init__(self, bsz, ntot, dt, dev):
        f = dict(dtype=dt, device=dev)
        i = dict(dtype=torch.int32, device=dev)
        self.rz = torch.empty(bsz, **f)
        self.rz_prev = torch.empty(bsz, **f)
        self.alpha = torch.zeros(bsz, **f)
        self.stop = torch.empty(bsz, **f)
        self.hi = torch.empty(bsz, **f)
        self.active = torch.empty(bsz, **f)
        self.live = torch.zeros(bsz, **i)
        self.par = torch.zeros(bsz, **i)
        self.k_done = torch.zeros(bsz, **i)
        d = dict(dtype=torch.float64, device=dev)
        self.parts = [torch.zeros(bsz * ntot, **d) for _ in range(3)]
        self.ptrs = pointers([self.rz, self.rz_prev, self.alpha, self.stop,
                              self.hi, self.live, self.par, self.k_done,
                              *self.parts])

    def load(self, rz, stop, hi, active):
        for dst, src in ((self.rz, rz), (self.stop, stop), (self.hi, hi),
                         (self.active, active)):
            dst.copy_(src)


class _Ring:
    """The graph route's window flags (``csrc/window.cuh``'s pinned ring,
    one per workspace: the graphs hold its addresses).  Flag ``j`` says
    whether an image was live at the start of iteration ``j``."""

    def __init__(self, lib, dev):
        self.lib = lib
        with torch.cuda.device(dev):
            self.handle = lib.deff_shard_ring_new()
        if not self.handle:
            raise RuntimeError("cg_steps_sharded: the window ring could not "
                               "be made")
        fin = weakref.finalize(self, lib.deff_shard_ring_free, self.handle)
        fin.atexit = False

    def flag(self, j):
        """Flag ``j``'s slot zeroed; its device address."""
        return self.lib.deff_shard_ring_flag(self.handle, j)

    def mark(self, j, stream):
        from ._build import check

        check(self.lib.deff_shard_ring_mark(self.handle, j, stream),
              "cg_steps_sharded (window flag event)")

    def live(self, j):
        """Flag ``j``, waiting for the finalize that marks it."""
        v = self.lib.deff_shard_ring_live(self.handle, j)
        if v < 0:
            raise RuntimeError(f"cg_steps_sharded (window flag): CUDA error "
                               f"{-v}")
        return v == 1


class _Group:
    """The shards of the row that one launch covers (one device, at most
    ``deff_shard_row_max()``): their pass tables, one per parity."""

    def __init__(self, dev, idx):
        self.dev, self.idx = dev, idx
        sg = len(idx)

        def table(slots):
            return ((ctypes.c_void_p * (slots * sg))(),
                    (ctypes.c_longlong * (slots * sg))())

        self.p = [table(P_SLOTS) for _ in range(2)]
        self.x = [table(X_SLOTS) for _ in range(2)]
        self.z = [table(Z_SLOTS) for _ in range(2)]
        self.ids = (ctypes.c_int * sg)(*idx)


class ShardWorkspace:
    """The buffers of K9's windows on one row of shards, for a whole solve.

    Every address stays fixed across the windows: x, the p and r ping-pong,
    z, q, e, the coarse rows (the shards' own planes, or their rows of
    ``coarse_plane``), the strips of the neighbours on other devices, the
    scalar state of each device and the pass tables of each parity, which
    read the neighbours' planes in place where they share the shard's
    device.  A window copies the caller's x, r, p and scalars in and the
    results out.  When every shard lies on one device (the graph route) the
    workspace also holds the two CUDA graphs of an iteration, one for each
    parity of the p/r ping-pong, captured at the first window with the
    ``coarse`` callable, omega, nu and over of that window (a later window
    with other ones captures anew), and the ring of window flags they mark.
    ``graph=False`` takes the host loop on one device too (to compare the
    two routes).  ``run_mgcg_sharded_fused`` keeps one per mesh row for a
    solve; :func:`cg_steps_sharded` makes one for a call without one."""

    def __init__(self, coefs, xs, graph=True, coarse_plane=None):
        from ._build import load_library

        lib = load_library()
        n = len(xs)
        bsz, ny, nx = xs[0].shape
        self.n = n
        self.shape, self.dtype = tuple(xs[0].shape), xs[0].dtype
        self.isz = xs[0].element_size()
        self.devices = [x.device for x in xs]
        self.graphed = graph and len(set(self.devices)) == 1
        # the tables and graphs read the coefficients by address: hold them
        self.coefs = [tuple(c) for c in coefs]
        self.coarse_plane = coarse_plane
        if coarse_plane is not None:
            _check_coarse_plane(coarse_plane, xs, "ShardWorkspace")
        self.nt = lib.deff_shard_tiles(ny, nx)
        self.ntot = n * self.nt
        self.states = {}
        for d in self.devices:
            if d not in self.states:
                self.states[d] = _DeviceState(bsz, self.ntot, self.dtype, d)
        self.st = [self.states[d] for d in self.devices]

        def planes():
            return [torch.empty_like(x) for x in xs]

        self.x = planes()
        self.P = [planes(), planes()]
        self.R = [planes(), planes()]
        self.z = planes()
        self.q = planes()
        self.e = planes()
        nyc, nxc = ny // 2, nx // 2
        if coarse_plane is None:
            self.rc = [x.new_empty((bsz, nyc, nxc)) for x in xs]
        else:
            self.rc = [coarse_plane[..., s * nyc:(s + 1) * nyc, :]
                       for s in range(n)]
        # the neighbour pairs that span two devices exchange strips
        self.cross = [self.devices[s] != self.devices[s + 1]
                      for s in range(n - 1)]
        self.strips = {}
        if any(self.cross):
            def strips(rows, cols):
                return tuple([x.new_zeros((bsz, rows, cols)) for x in xs]
                             for _ in range(2))

            self.strips = {nm: strips(HALO, nx)
                           for nm in ("p", "q", "r", "e", "z")}
            self.strips["ec"] = strips(HALO // 2, nxc)
        cap = lib.deff_shard_row_max()
        by_dev = {}
        for s, d in enumerate(self.devices):
            by_dev.setdefault(d, []).append(s)
        self.groups = [_Group(d, idx[i:i + cap]) for d, idx in by_dev.items()
                       for i in range(0, len(idx), cap)]
        self._tables()
        self.ring = _Ring(lib, self.devices[0]) if self.graphed else None
        self.graphs = None
        self.graph_key = None

    def sources(self, nm, planes):
        """Per shard, ``(body, north, south)`` of ``planes``: the
        neighbours' planes where they share the shard's device, the strips
        ``nm`` where they do not, ``None`` past the global edges."""
        out = []
        for s in range(self.n):
            north = south = None
            if s > 0:
                north = (self.strips[nm][0][s] if self.cross[s - 1]
                         else planes[s - 1])
            if s + 1 < self.n:
                south = (self.strips[nm][1][s] if self.cross[s]
                         else planes[s + 1])
            out.append((planes[s], north, south))
        return out

    def exchange(self, nm, planes):
        """Copy the rows next to each cross-device neighbour into its
        strips (nothing when the row is on one device)."""
        if not self.strips:
            return
        norths, souths = self.strips[nm]
        h = norths[0].shape[-2]
        for s in range(1, self.n):
            if self.cross[s - 1]:
                norths[s].copy_(planes[s - 1][..., -h:, :])
                souths[s - 1].copy_(planes[s][..., :h, :])
        cg_steps_sharded.exchanges += 1

    def _tables(self):
        isz = self.isz
        coef = coef_sources(self.coefs)
        for c in (0, 1):
            nxt = 1 - c
            srcs = {"z": self.sources("z", self.z),
                    "p": self.sources("p", self.P[c]),
                    "r": self.sources("r", self.R[c]),
                    "q": self.sources("q", self.q),
                    "e": self.sources("e", self.e),
                    "r_new": self.sources("r", self.R[nxt])}
            for g in self.groups:
                for j, s in enumerate(g.idx):
                    for tab, slots, planes, outs in (
                            (g.p[c], P_SLOTS, ("z", "p"),
                             (self.P[nxt][s], self.q[s])),
                            (g.x[c], X_SLOTS, ("r", "q"),
                             (self.P[nxt][s], self.x[s], self.R[nxt][s],
                              self.e[s], self.rc[s])),
                            (g.z[c], Z_SLOTS, ("e", "r_new"),
                             (self.z[s],))):
                        ptrs, strides = tab
                        at = j * slots
                        for k, src in enumerate(coef[s]):
                            _put(ptrs, strides, at + 3 * k, src, isz)
                        for k, nm in enumerate(planes):
                            _put(ptrs, strides, at + 9 + 3 * k, srcs[nm][s],
                                 isz)
                        base = at + (18 if slots == Z_SLOTS else 15)
                        for k, t in enumerate(outs):
                            ptrs[base + k] = t.data_ptr()
                            strides[base + k] = t.shape[-2] * t.shape[-1]
                    if self.coarse_plane is not None:
                        # rc: the shard's rows of the plane, at its stride
                        g.x[c][1][j * X_SLOTS + 19] = (
                            self.coarse_plane.shape[-2]
                            * self.coarse_plane.shape[-1])

    def set_coarse(self, c, ec):
        """Point pass Z's e_c slots of parity ``c`` at the coarse
        correction: one plane (``coarse_plane``'s shape, read in place) or
        the shards' planes (read in place, or from the ec strips across
        devices)."""
        if torch.is_tensor(ec):
            for g in self.groups:
                ptrs, strides = g.z[c]
                for j, s in enumerate(g.idx):
                    _put_gathered(ptrs, strides, j * Z_SLOTS + 15, ec, s,
                                  self.n, self.isz)
            return
        self.exchange("ec", ec)
        srcs = self.sources("ec", ec)
        for g in self.groups:
            ptrs, strides = g.z[c]
            for j, s in enumerate(g.idx):
                _put(ptrs, strides, j * Z_SLOTS + 15, srcs[s], self.isz)

    def check(self, coefs, xs, coarse_plane):
        def ptrs(cs):
            return [tuple(t.data_ptr() for t in c) for c in cs]

        if (tuple(xs[0].shape) != self.shape or xs[0].dtype != self.dtype
                or [x.device for x in xs] != self.devices
                or ptrs(coefs) != ptrs(self.coefs)
                or coarse_plane is not self.coarse_plane):
            raise ValueError("cg_steps_sharded: the workspace belongs to "
                             "other shards, coefficients or coarse plane")


def cg_steps_sharded(coefs: Sequence, xs: List[torch.Tensor],
                     rs: List[torch.Tensor], ps: List[torch.Tensor], rz,
                     active, stop, hi, k: int, *, coarse: Callable, omega,
                     nu: int, over: float, coarse_plane=None,
                     workspace=None):
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
        level 1); with ``coarse_plane``, ``coarse(coarse_plane, live)``
        maps that plane, the restrictions at each shard's rows, to the
        correction plane of its shape.  ``live`` holds each shard's
        per-image flags on its device (the images whose flag is 0 may skip
        the cycle: their corrections are not read).  It must not
        synchronise with the device.
      coarse_plane: ``(B, S ny_l/2, nx/2)`` on the shards' one device, or
        None (see above; ``parallel.fused2d.k9_coarse`` gives both).
      workspace: a :class:`ShardWorkspace` of these shards, coefficients
        and coarse plane kept across the windows of a solve (None: one for
        this call).
    Returns:
      ``(xs, rs, ps, rz, k_done)``; ``k_done`` is int32 ``(B,)`` on shard
      0's device.

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (float32 or float64, ``nu <= 4``, one launch a pass for the shards of
    a device) or raise.  Placement decides the route.  When every shard
    lies on one device, the iteration -- passes, finalizes and ``coarse``
    -- is captured once per workspace as a CUDA graph for each parity of
    the p/r ping-pong and replayed once an iteration with no host
    read-back between the replays: the live finalize marks a pinned flag,
    and before replay ``i >= WINDOW_LAG`` the host waits for the flag of
    iteration ``i - WINDOW_LAG`` and leaves the window if no image was live
    (so a window replays at most ``WINDOW_LAG`` iterations that start with
    none live).  When the shards span several devices (a graph cannot hold
    the copies between them), a host loop launches the iteration, reading
    ``any(live)`` before each one and ending the window when no image is
    live; only the neighbours on other devices exchange strips.  A failed
    capture raises.  ``cg_steps_sharded.replays`` counts the replays and
    ``cg_steps_sharded.exchanges`` the strip exchanges.
    """
    if nu < 1 or nu > MAX_NU:
        raise ValueError(f"cg_steps_sharded: nu={nu} must be in 1..{MAX_NU}")
    kw = dict(coarse=coarse, omega=omega, nu=nu, over=over,
              coarse_plane=coarse_plane)
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
    bsz, ny, nx = xs[0].shape
    for name, t in (("rz", rz), ("active", active), ("stop", stop),
                    ("hi", hi)):
        if tuple(t.shape) != (bsz,):
            raise ValueError(f"cg_steps_sharded: {name} shape "
                             f"{tuple(t.shape)}, expected ({bsz},)")
    lib = load_library()
    w = (ShardWorkspace(coefs, xs, coarse_plane=coarse_plane)
         if workspace is None else workspace)
    w.check(coefs, xs, coarse_plane)
    sfx = _CTYPE[w.dtype]
    ntot, st, states = w.ntot, w.st, w.states
    ws = weights(omega, nu)
    launch = {nm: getattr(lib, f"deff_shard_{nm}_{sfx}")
              for nm in ("p", "x", "z")}
    nyc = ny // 2

    def stream(dev):
        return torch.cuda.current_stream(dev).cuda_stream

    def sync_parts(which):
        """Copy each shard's partial slots to every other device."""
        if len(states) == 1:
            return
        nt = w.nt
        for s in range(n):
            for dst in states.values():
                if dst is st[s]:
                    continue
                dst.parts[which].view(bsz, n, nt)[:, s].copy_(
                    st[s].parts[which].view(bsz, n, nt)[:, s])

    def fin(kind, flag=None):
        for dev, sd in states.items():
            with torch.cuda.device(dev):
                check(getattr(lib, f"deff_shard_fin_{sfx}")(
                    kind, bsz, sd.ptrs, ntot, sd.active.data_ptr(), flag,
                    stream(dev)), "cg_steps_sharded (finalize)")

    def passes(nm, c, *extra):
        for g in w.groups:
            ptrs, strides = getattr(g, nm)[c]
            with torch.cuda.device(g.dev):
                check(launch[nm](len(g.idx), n, bsz, ny, nx, ptrs, strides,
                                 g.ids, states[g.dev].ptrs, *extra,
                                 stream(g.dev)),
                      f"cg_steps_sharded (pass {nm.upper()})")

    def iteration(c, flag=None):
        """One iteration reading the p and r buffers of parity c; the live
        finalize marks the window flag at device address ``flag``."""
        nxt = 1 - c
        passes("p", c)
        w.exchange("p", w.P[nxt])
        w.exchange("q", w.q)
        sync_parts(0)
        fin(1)
        passes("x", c, ws, nu)
        w.exchange("r", w.R[nxt])
        w.exchange("e", w.e)
        live = [sd.live for sd in st]
        if w.coarse_plane is not None:
            ec = coarse(w.coarse_plane, live)
            check_plane(ec, "cg_steps_sharded coarse correction",
                        tuple(w.coarse_plane.shape), w.coarse_plane)
        else:
            ec = coarse(w.rc, live)
            for s in range(n):
                check_plane(ec[s], f"cg_steps_sharded e_c[{s}]",
                            (bsz, nyc, nx // 2), xs[s])
        w.set_coarse(c, ec)
        passes("z", c, ws, nu, float(over))
        w.exchange("z", w.z)
        sync_parts(1)
        sync_parts(2)
        fin(2, flag)

    key = (tuple(ws), nu, float(over))
    if w.graphed and (w.graph_key is None or w.graph_key[0]() != coarse
                      or w.graph_key[1:] != key):
        w.graphs = _capture(iteration, w)
        # weakly: the coarse callable's owner may hold the workspace (a
        # bound method of the solve's row), and a dead one never matches
        w.graph_key = ((weakref.WeakMethod if inspect.ismethod(coarse)
                        else weakref.ref)(coarse),) + key

    # the window's state; z = p on entry
    for s in range(n):
        w.x[s].copy_(xs[s])
        w.P[0][s].copy_(ps[s])
        w.R[0][s].copy_(rs[s])
        w.z[s].copy_(ps[s])
    for sd in states.values():
        sd.load(rz, stop, hi, active)
    w.exchange("p", w.P[0])
    w.exchange("r", w.R[0])
    w.exchange("z", w.z)
    for s in range(n):
        with torch.cuda.device(w.devices[s]):
            check(getattr(lib, f"deff_shard_abs_parts_{sfx}")(
                bsz, ny, nx, w.R[0][s].data_ptr(), st[s].parts[1].data_ptr(),
                ntot, s * w.nt, stream(w.devices[s])),
                "cg_steps_sharded (sum|r|)")
    sync_parts(1)
    if w.graphed:
        ring, s0 = w.ring, stream(w.devices[0])
        fin(0, ring.flag(0))
        ring.mark(0, s0)
        # replay i writes flag i + 1; before replay i >= WINDOW_LAG wait
        # for flag i - WINDOW_LAG and leave if no image was live
        if k > 0 and ring.live(0):
            for i in range(k):
                if i >= WINDOW_LAG and not ring.live(i - WINDOW_LAG):
                    break
                ring.flag(i + 1)
                w.graphs[i % 2].replay()
                ring.mark(i + 1, s0)
                cg_steps_sharded.replays += 1
    else:
        fin(0)
        for i in range(k):
            if not bool(st[0].live.any()):
                break
            iteration(i % 2)
    # each image's p and r from the buffer its parity names
    select = getattr(lib, f"deff_shard_select_{sfx}")
    for s in range(n):
        with torch.cuda.device(w.devices[s]):
            check(select(bsz, ny * nx, rs[s].data_ptr(),
                         w.R[0][s].data_ptr(), w.R[1][s].data_ptr(),
                         ps[s].data_ptr(), w.P[0][s].data_ptr(),
                         w.P[1][s].data_ptr(), st[s].par.data_ptr(),
                         stream(w.devices[s])),
                  "cg_steps_sharded (parity copy)")
        xs[s].copy_(w.x[s])
    cg_steps_sharded.launches += 1
    return xs, rs, ps, st[0].rz.clone(), st[0].k_done.clone()


# Per device, the stream every K9 capture runs on and an anchor graph (one
# memset) that holds one memory pool for the process: each solve's graphs
# capture into that pool and die with their workspace, and the next
# solve's captures reuse the blocks they leave free there (the allocator
# keeps free blocks by stream and pool), where a pool per solve would stay
# reserved until the allocator's cache is emptied.  A graph's temporaries
# are made and consumed within one replay and its results go to its
# workspace's buffers, and graphs replay on one stream, so graphs that
# share the pool may reuse each other's free memory.
_SIDE = {}
_ANCHOR = {}


def _capture(iteration, w):
    """The two graphs of an iteration (parity 0 and 1) on the workspace's
    device, after one eager run with every image dead (it moves no data but
    the scratch's) so that first-use work, such as loading a kernel, stays
    out of the capture.  The graph of parity ``c`` runs iterations ``i``
    with ``i % 2 == c`` and marks flag ``i + 1``, whose slot of the ring is
    ``(i + 1) % 2 = 1 - c`` (``csrc/cgstep_sharded.cu``).  Captured with
    ``capture_begin`` and ``capture_end`` (``torch.cuda.graph`` would also
    synchronise, collect garbage and empty the allocator's cache, twice a
    solve)."""
    dev = w.devices[0]
    for sd in w.states.values():
        sd.live.zero_()
    main = torch.cuda.current_stream(dev)
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    side = _SIDE[dev]
    side.wait_stream(main)
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with torch.cuda.device(dev), torch.cuda.stream(side):
        iteration(0)
        if dev not in _ANCHOR:
            anchor = torch.cuda.CUDAGraph()
            anchor.capture_begin(capture_error_mode="thread_local")
            try:
                torch.empty(1, device=dev).zero_()
            finally:
                anchor.capture_end()
            _ANCHOR[dev] = anchor
        for c, g in enumerate(graphs):
            g.capture_begin(pool=_ANCHOR[dev].pool(),
                            capture_error_mode="thread_local")
            try:
                iteration(c, w.ring.flag(1 - c))
            finally:
                g.capture_end()
    main.wait_stream(side)
    return graphs


cg_steps_sharded.launches = 0
cg_steps_sharded.replays = 0
cg_steps_sharded.exchanges = 0
