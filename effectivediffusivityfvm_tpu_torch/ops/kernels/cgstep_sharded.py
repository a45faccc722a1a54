"""K9: up to ``k`` multigrid-preconditioned CG iterations per image on a row
of shards, each iteration three passes per shard with the per-image scalars
summed over the shards between them -- the CUDA kernels
(``csrc/cgstep_sharded.cu`` over ``csrc/tiled.cuh`` and
``csrc/cgscalars.cuh``), replayed from CUDA graphs when the shards share a
device and launched from a host loop when they do not, and its plain
PyTorch version.

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
  JAX loop's ``(i < k) & reduce_any(live)``): the plain version and the
  host loop leave it, the graph route replays gated iterations that change
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

import inspect
import weakref
from typing import Callable, List, Sequence

import torch

from ...parallel.mesh import halo_strips
from ..fvm import guarded_inverse
from .vcycle import _CTYPE, _nbsum, check_plane, smoothing_schedule, weights
from .vcycle_sharded import (HALO, MAX_NU, check_coarse, check_shard,
                             pointers, window)
from .vcycle_tiled import post_reference, pre_reference

__all__ = ["cg_steps_sharded_reference", "cg_steps_sharded",
           "ShardWorkspace"]


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


class ShardWorkspace:
    """The buffers of K9's windows on one row of shards, for a whole solve.

    Every address stays fixed across the windows: x, the p and r ping-pong,
    z, e, the restricted residual, the halo strips, the scalar state of each
    device and the ctypes pointer arrays of passes A and B.  A window copies
    the caller's x, r, p and scalars in and the results out.  When every
    shard lies on one device (the graph route) the workspace also holds the
    two CUDA graphs of an iteration, one for each parity of the p/r
    ping-pong, captured at the first window with the ``coarse`` callable,
    omega, nu and over of that window; a later window with other ones
    captures anew.  ``graph=False`` takes the host loop on one device too
    (to compare the two routes).  ``run_mgcg_sharded_fused`` keeps one per
    mesh row for a solve; :func:`cg_steps_sharded` makes one for a call
    without one."""

    def __init__(self, coefs, xs, graph=True):
        from ._build import load_library

        lib = load_library()
        n = len(xs)
        bsz, ny, nx = xs[0].shape
        self.shape, self.dtype = tuple(xs[0].shape), xs[0].dtype
        self.devices = [x.device for x in xs]
        self.graphed = graph and len(set(self.devices)) == 1
        # the graphs read the coefficients by address: hold them
        self.coefs = [tuple(c) for c in coefs]
        self.nt = lib.deff_shard_tiles(ny, nx)
        self.ntot = n * self.nt
        self.states = {}
        for d in self.devices:
            if d not in self.states:
                self.states[d] = _DeviceState(bsz, self.ntot, self.dtype, d)
        self.st = [self.states[d] for d in self.devices]

        def planes():
            return [torch.empty_like(x) for x in xs]

        def strips(rows, cols):
            return tuple([x.new_zeros((bsz, rows, cols)) for x in xs]
                         for _ in range(2))

        self.x = planes()
        self.P = [planes(), planes()]
        self.R = [planes(), planes()]
        self.z = planes()
        self.e = planes()
        self.rc = [x.new_empty((bsz, ny // 2, nx // 2)) for x in xs]
        self.strips = {nm: strips(HALO, nx) for nm in ("p", "r", "e", "z")}
        self.ecs_strips = strips(HALO // 2, nx // 2)
        # passes A and B read fixed planes: their pointer arrays per parity
        self.ptrs_a = [[pointers(self.coefs[s] + self.rows("z", self.z, s)
                                 + self.rows("p", self.P[c], s))
                        for s in range(n)] for c in (0, 1)]
        self.ptrs_b = [[pointers(self.coefs[s]
                                 + self.rows("p", self.P[1 - c], s)
                                 + self.rows("r", self.R[c], s))
                        for s in range(n)] for c in (0, 1)]
        self.graphs = None
        self.graph_key = None

    def rows(self, nm, planes, s):
        north, south = self.strips[nm]
        return (planes[s], north[s], south[s])

    def check(self, coefs, xs):
        def ptrs(cs):
            return [tuple(t.data_ptr() for t in c) for c in cs]

        if (tuple(xs[0].shape) != self.shape or xs[0].dtype != self.dtype
                or [x.device for x in xs] != self.devices
                or ptrs(coefs) != ptrs(self.coefs)):
            raise ValueError("cg_steps_sharded: the workspace belongs to "
                             "other shards or coefficients")


def cg_steps_sharded(coefs: Sequence, xs: List[torch.Tensor],
                     rs: List[torch.Tensor], ps: List[torch.Tensor], rz,
                     active, stop, hi, k: int, *, coarse: Callable, omega,
                     nu: int, over: float, workspace=None):
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
        are not read).  It must not synchronise with the device.
      workspace: a :class:`ShardWorkspace` of these shards and coefficients
        kept across the windows of a solve (None: one for this call).
    Returns:
      ``(xs, rs, ps, rz, k_done)``; ``k_done`` is int32 ``(B,)`` on shard
      0's device.

    CPU tensors run the plain version; CUDA tensors launch the kernels
    (float32 or float64, ``nu <= 4``) or raise.  Placement decides the
    route.  When every shard lies on one device, the iteration -- passes,
    exchanges, finalizes and ``coarse`` -- is captured once per workspace
    as a CUDA graph for each parity of the p/r ping-pong and replayed ``k``
    times when an image is live at the window's start (one read of
    ``any(live)``), with no host read-back between the iterations: an
    iteration after the last image died runs only gated launches and the
    copies around them.  When the shards span several
    devices (a graph cannot hold the copies between them), a host loop
    launches the iteration, reading ``any(live)`` before each one and
    ending the window when no image is live.  A failed capture raises.
    ``cg_steps_sharded.replays`` counts the replays.
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
    bsz, ny, nx = xs[0].shape
    for name, t in (("rz", rz), ("active", active), ("stop", stop),
                    ("hi", hi)):
        if tuple(t.shape) != (bsz,):
            raise ValueError(f"cg_steps_sharded: {name} shape "
                             f"{tuple(t.shape)}, expected ({bsz},)")
    lib = load_library()
    w = ShardWorkspace(coefs, xs) if workspace is None else workspace
    w.check(coefs, xs)
    sfx = _CTYPE[w.dtype]
    nt, ntot, st, states = w.nt, w.ntot, w.st, w.states
    ws = weights(omega, nu)
    pass_a = getattr(lib, f"deff_shard_pass_a_{sfx}")
    pass_b = getattr(lib, f"deff_shard_pass_b_{sfx}")
    pass_c = getattr(lib, f"deff_shard_pass_c_{sfx}")

    def stream(s):
        return torch.cuda.current_stream(w.devices[s]).cuda_stream

    def exchange(nm, planes):
        halo_strips(planes, HALO, out=w.strips[nm])

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
        for dev, sd in states.items():
            check(getattr(lib, f"deff_shard_fin_{sfx}")(
                kind, bsz, sd.ptrs, ntot, sd.active.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream),
                "cg_steps_sharded (finalize)")

    def iteration(c):
        """One iteration reading the p and r buffers of parity c."""
        nxt = 1 - c
        for s in range(n):
            check(pass_a(bsz, ny, nx, HALO, w.ptrs_a[c][s],
                         w.P[nxt][s].data_ptr(), st[s].ptrs, ntot, s * nt,
                         nu, stream(s)), "cg_steps_sharded (pass A)")
        exchange("p", w.P[nxt])
        sync_parts(0)
        fin(1)
        for s in range(n):
            check(pass_b(bsz, ny, nx, HALO, w.ptrs_b[c][s], w.x[s].data_ptr(),
                         w.R[nxt][s].data_ptr(), w.e[s].data_ptr(),
                         w.rc[s].data_ptr(), st[s].ptrs, ntot, s * nt, ws,
                         nu, stream(s)), "cg_steps_sharded (pass B)")
        exchange("r", w.R[nxt])
        exchange("e", w.e)
        ecs = coarse(w.rc, [sd.live for sd in st])
        ecn, ecss = halo_strips(ecs, HALO // 2, out=w.ecs_strips)
        for s in range(n):
            check_coarse(ecs[s], ecn[s], ecss[s], xs[s], "cg_steps_sharded")
            planes = pointers(tuple(coefs[s]) + w.rows("e", w.e, s)
                              + w.rows("r", w.R[nxt], s)
                              + (ecs[s], ecn[s], ecss[s]))
            check(pass_c(bsz, ny, nx, HALO, planes, w.z[s].data_ptr(),
                         float(over), st[s].ptrs, ntot, s * nt, ws, nu,
                         stream(s)), "cg_steps_sharded (pass C)")
        exchange("z", w.z)
        sync_parts(1)
        sync_parts(2)
        fin(2)

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
    exchange("p", w.P[0])
    exchange("r", w.R[0])
    exchange("z", w.z)
    for s in range(n):
        check(getattr(lib, f"deff_shard_abs_parts_{sfx}")(
            bsz, ny, nx, w.R[0][s].data_ptr(), st[s].parts[1].data_ptr(),
            ntot, s * nt, stream(s)), "cg_steps_sharded (sum|r|)")
    sync_parts(1)
    fin(0)
    if w.graphed:
        # the loop's test before its first iteration; none between them
        if k > 0 and bool(st[0].live.any()):
            for i in range(k):
                w.graphs[i % 2].replay()
            cg_steps_sharded.replays += k
    else:
        for i in range(k):
            if not bool(st[0].live.any()):
                break
            iteration(i % 2)
    # each image's p and r from the buffer its parity names
    select = getattr(lib, f"deff_shard_select_{sfx}")
    for s in range(n):
        check(select(bsz, ny * nx, rs[s].data_ptr(), w.R[0][s].data_ptr(),
                     w.R[1][s].data_ptr(), ps[s].data_ptr(),
                     w.P[0][s].data_ptr(), w.P[1][s].data_ptr(),
                     st[s].par.data_ptr(), stream(s)),
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
    out of the capture.  Captured with ``capture_begin`` and ``capture_end``
    (``torch.cuda.graph`` would also synchronise, collect garbage and empty
    the allocator's cache, twice a solve)."""
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
                iteration(c)
            finally:
                g.capture_end()
    main.wait_stream(side)
    return graphs


cg_steps_sharded.launches = 0
cg_steps_sharded.replays = 0
