"""K8: one level of the row-sharded V-cycle -- the CUDA kernels
(``csrc/vcycle_sharded.cu``: K2's level passes of ``csrc/levelpass2d.cuh``
in the banded sweep form, one launch a leg for every shard of a mesh row on
one device) and their plain PyTorch versions.

Replaces ``effectivediffusivityfvm_tpu/parallel/fused2d.py``
(``_v_cycle_sharded_fused_impl``: ``_t1s_kernel``, ``_t2s_kernel``, and the
in-shard banded ``_banded_level``).  A shard holds rows ``[0, ny_l)`` of a
level; the rows above (north) and below (south) come from its neighbours,
zeros past the global top and bottom:

* T1: on the window ``[north | shard | south]``, ``e = (w0 dinv) r``, the
  damped-Jacobi sweeps at ``ws[1:]``, the residual ``r - (diag e -
  nbsum(e))`` and its 2x2 block sum; returns ``e`` and the coarse residual
  on the shard's rows;
* T2: ``e + over * e_c[i//2, j//2]`` on the window, the coarse correction's
  rows above and below read likewise (``HALO // 2`` coarse rows; every
  shard starts on an even global row, so fine window row ``i`` takes coarse
  row ``i // 2``), then the sweeps in reverse; returns ``z``.

``nu`` sweeps and the residual invalidate ``nu + 1`` rows at the window's
edge, fewer than ``HALO``, so the shard's rows are exact.

A plane of a shard is given as a source ``(body, north, south)``: ``north``
is a ``(B, rows, nx)`` plane whose last rows lie above the shard -- the
neighbour's own plane, read in place where it shares the shard's device
(:func:`neighbour_sources`), or a strip exchanged from it where it does not
-- and ``south`` one whose first rows lie below; ``None`` past the global
edges (zeros).  The legs:

* :func:`shard_row_t1` / :func:`shard_row_t2` on a :class:`ShardRow`: every
  shard of a row, one launch a leg per device; the row's tables (pointer
  arrays, coefficient sources, e and coarse buffers) are built once, and a
  call fills in the planes it is given.  T1's restrictions can land at each
  shard's row offset in the gathered coarse plane (``ShardRow(...,
  gathered=True)``), from which T2 then reads ``e_c`` in place;
* :func:`shard_t1` / :func:`shard_t2`: one shard with the caller's strips
  (the JAX engine's form), a row of one shard.

The recursion over levels and the coarse tail are the caller's
(``parallel/fused2d.py``).  On a CUDA tensor the wrappers launch the
kernels (or raise); on a CPU tensor they run the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ...parallel.mesh import halo_strips
from .vcycle import _CTYPE, check_plane, smoothing_schedule, weights
from .vcycle_tiled import HALO, post_reference, pre_reference

__all__ = ["HALO", "MAX_NU", "window", "neighbour_sources", "coef_sources",
           "ShardRow", "shard_row_t1_reference", "shard_row_t2_reference",
           "shard_row_t1", "shard_row_t2", "shard_t1_reference",
           "shard_t2_reference", "shard_t1", "shard_t2"]

MAX_NU = 4          # the JAX engine's guard: nu + 2 <= HALO with room left


def window(body, north, south):
    """``[north | body | south]`` along the rows."""
    return torch.cat([north, body, south], dim=-2)


def _coef_window_planes(coef):
    """The ``(aw, an, dinv)`` windows of a shard's coefficient triples."""
    return tuple(window(*coef[i:i + 3]) for i in (0, 3, 6))


def shard_t1_reference(coef, r, rn, rs, *, omega, nu):
    """Plain T1 on one shard: ``coef`` is ``(aw, awN, awS, an, anN, anS,
    dinv, dinvN, dinvS)``, ``r`` ``(B, ny_l, nx)`` with strips ``rn``/``rs``
    ``(B, HALO, nx)``; returns ``(e, rc)``, ``rc`` ``(B, ny_l/2, nx/2)``."""
    ws = smoothing_schedule(omega, nu)
    ny = r.shape[-2]
    e, rc = pre_reference(_coef_window_planes(coef), window(r, rn, rs), ws)
    return (e[..., HALO:HALO + ny, :],
            rc[..., HALO // 2:HALO // 2 + ny // 2, :])


def shard_t2_reference(coef, e, en, es, r, rn, rs, ec, ecn, ecs, *, omega,
                       nu, over):
    """Plain T2 on one shard: ``e``/``r`` with ``HALO``-row strips, the
    coarse correction ``ec`` ``(B, ny_l/2, nx/2)`` with ``HALO // 2``-row
    strips; returns ``z`` ``(B, ny_l, nx)``."""
    ws = smoothing_schedule(omega, nu)
    ny = r.shape[-2]
    z = post_reference(_coef_window_planes(coef), window(e, en, es),
                       window(r, rn, rs), window(ec, ecn, ecs), ws, over)
    return z[..., HALO:HALO + ny, :]


def _check_nu(nu, what):
    if nu < 1 or nu > MAX_NU:
        raise ValueError(f"{what}: nu={nu} must be in 1..{MAX_NU}")


def check_shard(planes, like, what):
    """Check ``(body, north, south)`` triples against ``like``'s batch, dtype
    and device: bodies ``(B, ny_l, nx)`` (``ny_l``, ``nx`` even, ``ny_l >=
    HALO``), strips ``(B, HALO, nx)``."""
    if like.dtype not in _CTYPE:
        raise ValueError(f"{what}: kernels take float32 or float64, not "
                         f"{like.dtype}")
    bsz, ny, nx = like.shape
    if ny % 2 or nx % 2 or ny < HALO:
        raise ValueError(f"{what}: shard rows {ny} and columns {nx} must be "
                         f"even, with at least {HALO} rows")
    for i in range(0, len(planes), 3):
        body, north, south = planes[i:i + 3]
        check_plane(body, f"{what} plane {i // 3}", (bsz, ny, nx), like)
        check_plane(north, f"{what} north strip {i // 3}", (bsz, HALO, nx),
                    like)
        check_plane(south, f"{what} south strip {i // 3}", (bsz, HALO, nx),
                    like)


def check_coarse(ec, ecn, ecs, like, what):
    bsz, ny, nx = like.shape
    check_plane(ec, f"{what} e_c", (bsz, ny // 2, nx // 2), like)
    for nm, t in (("north", ecn), ("south", ecs)):
        check_plane(t, f"{what} e_c {nm} strip", (bsz, HALO // 2, nx // 2),
                    like)


def pointers(tensors):
    """A ctypes array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _device_of(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")


# ------------------------------------------------------------ row sources

def neighbour_sources(xs, h):
    """Per shard of a row, the source ``(body, north, south)`` of the planes
    ``xs``: north the plane of the shard above and south that of the shard
    below, read in place where they share the shard's device; where they do
    not, the ``h`` rows next to the shard exchanged as strips
    (:func:`~...parallel.mesh.halo_strips`); ``None`` past the global
    edges."""
    n = len(xs)
    devs = [x.device for x in xs]
    if len(set(devs)) == 1:
        return [(x, xs[s - 1] if s > 0 else None,
                 xs[s + 1] if s + 1 < n else None) for s, x in enumerate(xs)]
    norths, souths = halo_strips(xs, h)
    out = []
    for s, x in enumerate(xs):
        north = south = None
        if s > 0:
            north = xs[s - 1] if devs[s - 1] == devs[s] else norths[s]
        if s + 1 < n:
            south = xs[s + 1] if devs[s + 1] == devs[s] else souths[s]
        out.append((x, north, south))
    return out


def coef_sources(coefs):
    """The coefficient sources ``(aw, an, dinv)`` per shard of a row from
    its coefficient windows ``(aw, awN, awS, an, anN, anS, dinv, dinvN,
    dinvS)`` (``fused2d._coef_windows``): the neighbours' planes in place
    where they share the shard's device, their strips where they do not,
    ``None`` past the global edges."""
    n = len(coefs)
    out = []
    for s, c in enumerate(coefs):
        planes = []
        for k in (0, 3, 6):
            body = c[k]
            north = south = None
            if s > 0:
                prev = coefs[s - 1][k]
                north = prev if prev.device == body.device else c[k + 1]
            if s + 1 < n:
                nxt = coefs[s + 1][k]
                south = nxt if nxt.device == body.device else c[k + 2]
            planes.append((body, north, south))
        out.append(tuple(planes))
    return out


def _rows(src, h):
    """``[north rows | body | south rows]`` of a source, ``h`` rows each
    side, zeros where a side is ``None``."""
    body, north, south = src
    dev = body.device
    zero = body.new_zeros(body.shape[:-2] + (h, body.shape[-1]))
    n = zero if north is None else north[..., -h:, :].to(dev)
    s = zero if south is None else south[..., :h, :].to(dev)
    return window(body, n, s)


def _split_gathered(g, n):
    """A gathered coarse plane ``(B, n * ny_c, nx_c)`` as the sources of its
    ``n`` shards, each neighbour read in place."""
    parts = list(torch.split(g, g.shape[-2] // n, dim=-2))
    return [(p, parts[s - 1] if s > 0 else None,
             parts[s + 1] if s + 1 < n else None)
            for s, p in enumerate(parts)]


# ------------------------------------------------------------ ShardRow

class ShardRow:
    """K8's tables for one level of a mesh row, built once per hierarchy.

    ``coefs`` are the shards' coefficient sources in row order
    (:func:`coef_sources`), bodies ``(B, ny_l, nx)``.  On a card the shards
    are grouped by device (at most ``deff_shard_row_max()`` a launch) and
    each group gets its pointer and stride tables, its e buffer ``(S_g, B,
    ny_l, nx)`` and its coarse buffer; a call fills in the planes it is
    given.  ``gathered=True`` (every shard on one device): T1 writes the
    restrictions into :attr:`gathered` ``(B, S ny_l/2, nx/2)``, shard ``s``
    at rows ``[s ny_l/2, (s+1) ny_l/2)``, the coarse tail's level-0 plane.
    """

    T1_SLOTS = 14          # aw, an, dinv, r (three slots each), e, rc
    T2_SLOTS = 19          # aw, an, dinv, e, r, e_c (three each), z

    def __init__(self, coefs, *, gathered: bool = False):
        self.coefs = list(coefs)
        like = self.coefs[0][0][0]
        self.n = len(self.coefs)
        self.shape = tuple(like.shape)
        bsz, ny, nx = self.shape
        self.dtype, self.device = like.dtype, like.device
        self.isz = like.element_size()
        self.gathered = None
        if gathered:
            if any(c[0][0].device != like.device for c in self.coefs):
                raise ValueError("ShardRow: the gathered plane needs every "
                                 "shard on one device")
            self.gathered = torch.empty(
                (bsz, self.n * (ny // 2), nx // 2), dtype=like.dtype,
                device=like.device)
        self.groups = []
        self.tail_args = None     # LevelArgs of the gathered tail (caller's)
        if like.device.type == "cuda":
            self._tables()

    def _tables(self):
        from ._build import load_library

        if self.dtype not in _CTYPE:
            raise ValueError(f"ShardRow: kernels take float32 or float64, "
                             f"not {self.dtype}")
        bsz, ny, nx = self.shape
        if ny % 2 or nx % 2 or ny < HALO:
            raise ValueError(f"ShardRow: shard rows {ny} and columns {nx} "
                             f"must be even, with at least {HALO} rows")
        for s, planes in enumerate(self.coefs):
            for k, src in enumerate(planes):
                _check_source(src, f"ShardRow shard {s} plane {k}",
                              self.shape, src[0])
        cap = load_library().deff_shard_row_max()
        by_dev = {}
        for s, planes in enumerate(self.coefs):
            by_dev.setdefault(planes[0][0].device, []).append(s)
        for dev, idx in by_dev.items():
            for i in range(0, len(idx), cap):
                self.groups.append(_Group(self, dev, idx[i:i + cap]))


def _check_source(src, what, shape, like, need=HALO):
    """A source's body is ``shape``; its north and south planes share its
    batch, width, dtype and device, are contiguous, and hold the ``need``
    rows the window may read."""
    body, north, south = src
    check_plane(body, what, shape, like)
    bsz, ny, nx = shape
    for nm, t in (("north", north), ("south", south)):
        if t is None:
            continue
        if (t.dim() != 3 or t.shape[0] != bsz or t.shape[-1] != nx
                or t.shape[-2] < need):
            raise ValueError(f"{what} {nm}: shape {tuple(t.shape)}, expected "
                             f"({bsz}, >= {need}, {nx})")
        check_plane(t, f"{what} {nm}", tuple(t.shape), like)


class _Group:
    """The shards of a row that one launch covers: their tables."""

    def __init__(self, row, dev, idx):
        bsz, ny, nx = row.shape
        self.row, self.dev, self.idx = row, dev, idx
        sg = len(idx)
        self.e = torch.empty((sg, bsz, ny, nx), dtype=row.dtype, device=dev)
        self.rc = (None if row.gathered is not None else
                   torch.empty((sg, bsz, ny // 2, nx // 2), dtype=row.dtype,
                               device=dev))
        self.p1 = (ctypes.c_void_p * (ShardRow.T1_SLOTS * sg))()
        self.s1 = (ctypes.c_longlong * (ShardRow.T1_SLOTS * sg))()
        self.p2 = (ctypes.c_void_p * (ShardRow.T2_SLOTS * sg))()
        self.s2 = (ctypes.c_longlong * (ShardRow.T2_SLOTS * sg))()
        nyc, nxc = ny // 2, nx // 2
        for j, s in enumerate(idx):
            b1, b2 = j * ShardRow.T1_SLOTS, j * ShardRow.T2_SLOTS
            for k, src in enumerate(row.coefs[s]):
                _put(self.p1, self.s1, b1 + 3 * k, src, row.isz)
                _put(self.p2, self.s2, b2 + 3 * k, src, row.isz)
            self.p1[b1 + 12] = self.e[j].data_ptr()
            self.s1[b1 + 12] = ny * nx
            if row.gathered is not None:
                g = row.gathered
                self.p1[b1 + 13] = g.data_ptr() + s * nyc * nxc * row.isz
                self.s1[b1 + 13] = g.shape[-2] * nxc
            else:
                self.p1[b1 + 13] = self.rc[j].data_ptr()
                self.s1[b1 + 13] = nyc * nxc


def _put(ptrs, strides, at, src, isz):
    """Write a source into slots ``at..at+2``: the body at image 0, row 0;
    one row past the last row of the plane above; the first row of the
    plane below; each with its image stride in elements (a null pointer
    and 0 past the global edges)."""
    body, north, south = src
    for k, t in ((0, body), (2, south)):
        ptrs[at + k] = t.data_ptr() if t is not None else None
        strides[at + k] = t.shape[-2] * t.shape[-1] if t is not None else 0
    if north is None:
        ptrs[at + 1] = None
        strides[at + 1] = 0
    else:
        n = north.shape[-2] * north.shape[-1]
        ptrs[at + 1] = north.data_ptr() + n * isz
        strides[at + 1] = n


def _put_gathered(ptrs, strides, at, g, s, n, isz):
    """The coarse source of shard ``s`` of ``n`` read in place from the
    gathered plane ``g``: its rows, the rows above and below it in ``g``
    (none past the global edges), every image stride ``g``'s plane."""
    rows = g.shape[-2] // n
    plane = g.shape[-2] * g.shape[-1]
    body = g.data_ptr() + s * rows * g.shape[-1] * isz
    ptrs[at] = body
    ptrs[at + 1] = body if s > 0 else None
    ptrs[at + 2] = (body + rows * g.shape[-1] * isz if s + 1 < n else None)
    strides[at] = strides[at + 1] = strides[at + 2] = plane


def shard_row_t1_reference(row: ShardRow, r_src, *, omega, nu):
    """Plain T1 on every shard of ``row`` (sources ``r_src``, one per
    shard): ``(es, rcs)``, the restrictions written into ``row.gathered``
    (and ``rcs`` its views) when the row has one."""
    ws = smoothing_schedule(omega, nu)
    ny = row.shape[1]
    es, rcs = [], []
    for s, (coef, rsrc) in enumerate(zip(row.coefs, r_src)):
        e, rc = pre_reference(tuple(_rows(c, HALO) for c in coef),
                              _rows(rsrc, HALO), ws)
        es.append(e[..., HALO:HALO + ny, :])
        rc = rc[..., HALO // 2:HALO // 2 + ny // 2, :]
        if row.gathered is not None:
            view = row.gathered[..., s * (ny // 2):(s + 1) * (ny // 2), :]
            view.copy_(rc)
            rc = view
        rcs.append(rc)
    return es, rcs


def shard_row_t2_reference(row: ShardRow, e_src, r_src, ec_src, *, omega,
                           nu, over):
    """Plain T2 on every shard of ``row``: the sources of ``e``, ``r`` and
    the coarse correction per shard (``ec_src`` may instead be the gathered
    coarse plane, read in place); returns the ``z`` of every shard."""
    ws = smoothing_schedule(omega, nu)
    ny = row.shape[1]
    if torch.is_tensor(ec_src):
        ec_src = _split_gathered(ec_src, row.n)
    out = []
    for coef, es, rs, ecs in zip(row.coefs, e_src, r_src, ec_src):
        z = post_reference(tuple(_rows(c, HALO) for c in coef),
                           _rows(es, HALO), _rows(rs, HALO),
                           _rows(ecs, HALO // 2), ws, over)
        out.append(z[..., HALO:HALO + ny, :])
    return out


def _fill(g, ptrs, strides, per, plane, srcs, shape, need=HALO):
    """Write shard sources ``srcs`` (one per shard of the row) into plane
    slot ``plane`` of group ``g``'s tables.  Each body is checked once; a
    north or south plane that is another shard's body needs no more
    checks, a strip gets its own."""
    isz = g.row.isz
    bodies = {id(src[0]) for src in srcs}
    for j, s in enumerate(g.idx):
        src = srcs[s]
        body = src[0]
        if not (body.shape == shape and body.dtype == g.row.dtype
                and body.device == g.dev and body.is_contiguous()):
            check_plane(body, f"shard {s} plane {plane}", shape, g.e)
        if any(t is not None and id(t) not in bodies for t in src[1:]):
            _check_source(src, f"shard {s} plane {plane}", shape, g.e, need)
        _put(ptrs, strides, j * per + 3 * plane, src, isz)


def shard_row_t1(row: ShardRow, r_src, *, omega, nu):
    """T1 of every shard of ``row`` (see :func:`shard_row_t1_reference`):
    one launch per device group.  A CPU row runs the plain version."""
    _check_nu(nu, "shard_row_t1")
    if row.device.type == "cpu":
        return shard_row_t1_reference(row, r_src, omega=omega, nu=nu)
    _device_of(row.coefs[0][0][0], "shard_row_t1")
    from ._build import check, load_library

    lib = load_library()
    fn = getattr(lib, f"deff_shard_row_t1_{_CTYPE[row.dtype]}")
    bsz, ny, nx = row.shape
    ws = weights(omega, nu)
    es, rcs = [None] * row.n, [None] * row.n
    for g in row.groups:
        _fill(g, g.p1, g.s1, ShardRow.T1_SLOTS, 3, r_src, row.shape)
        with torch.cuda.device(g.dev):
            stream = torch.cuda.current_stream().cuda_stream
            check(fn(len(g.idx), bsz, ny, nx, g.p1, g.s1, ws, nu, stream),
                  "shard_row_t1")
        shard_row_t1.launches += 1
        for j, s in enumerate(g.idx):
            es[s] = g.e[j]
            rcs[s] = (g.rc[j] if g.rc is not None else
                      row.gathered[..., s * (ny // 2):(s + 1) * (ny // 2), :])
    return es, rcs


def shard_row_t2(row: ShardRow, e_src, r_src, ec_src, *, omega, nu, over):
    """T2 of every shard of ``row`` (see :func:`shard_row_t2_reference`):
    one launch per device group; the ``z`` of each group's shards are views
    of one new tensor.  A CPU row runs the plain version."""
    _check_nu(nu, "shard_row_t2")
    if row.device.type == "cpu":
        return shard_row_t2_reference(row, e_src, r_src, ec_src,
                                      omega=omega, nu=nu, over=over)
    _device_of(row.coefs[0][0][0], "shard_row_t2")
    from ._build import check, load_library

    lib = load_library()
    fn = getattr(lib, f"deff_shard_row_t2_{_CTYPE[row.dtype]}")
    bsz, ny, nx = row.shape
    ws = weights(omega, nu)
    gathered = torch.is_tensor(ec_src)
    if gathered:
        check_plane(ec_src, "shard_row_t2 gathered e_c",
                    (bsz, row.n * (ny // 2), nx // 2), row.coefs[0][0][0])
    per = ShardRow.T2_SLOTS
    out = [None] * row.n
    for g in row.groups:
        _fill(g, g.p2, g.s2, per, 3, e_src, row.shape)
        _fill(g, g.p2, g.s2, per, 4, r_src, row.shape)
        if gathered:
            for j, s in enumerate(g.idx):
                _put_gathered(g.p2, g.s2, j * per + 15, ec_src, s, row.n,
                              row.isz)
        else:
            _fill(g, g.p2, g.s2, per, 5, ec_src, (bsz, ny // 2, nx // 2),
                  HALO // 2)
        z = torch.empty((len(g.idx), bsz, ny, nx), dtype=row.dtype,
                        device=g.dev)
        for j, s in enumerate(g.idx):
            g.p2[j * per + 18] = z[j].data_ptr()
            g.s2[j * per + 18] = ny * nx
            out[s] = z[j]
        with torch.cuda.device(g.dev):
            stream = torch.cuda.current_stream().cuda_stream
            check(fn(len(g.idx), bsz, ny, nx, g.p2, g.s2, ws, nu,
                     float(over), stream), "shard_row_t2")
        shard_row_t2.launches += 1
    return out


def _strip_row(coef):
    """A one-shard row from a coefficient window with the caller's
    strips."""
    return ShardRow([tuple((coef[k], coef[k + 1], coef[k + 2])
                           for k in (0, 3, 6))])


def shard_t1(coef, r, rn, rs, *, omega, nu):
    """T1 of one shard with the caller's strips (see
    :func:`shard_t1_reference`): ``(e, rc)``.  A CPU tensor runs the plain
    version; a CUDA tensor launches the row kernel on a row of one."""
    _check_nu(nu, "shard_t1")
    if r.device.type == "cpu":
        return shard_t1_reference(coef, r, rn, rs, omega=omega, nu=nu)
    _device_of(r, "shard_t1")
    check_shard(tuple(coef) + (r, rn, rs), r, "shard_t1")
    es, rcs = shard_row_t1(_strip_row(coef), [(r, rn, rs)], omega=omega,
                           nu=nu)
    shard_t1.launches += 1
    return es[0], rcs[0]


def shard_t2(coef, e, en, es, r, rn, rs, ec, ecn, ecs, *, omega, nu, over):
    """T2 of one shard with the caller's strips (see
    :func:`shard_t2_reference`): ``z``.  A CPU tensor runs the plain
    version; a CUDA tensor launches the row kernel on a row of one."""
    _check_nu(nu, "shard_t2")
    if r.device.type == "cpu":
        return shard_t2_reference(coef, e, en, es, r, rn, rs, ec, ecn, ecs,
                                  omega=omega, nu=nu, over=over)
    _device_of(r, "shard_t2")
    check_shard(tuple(coef) + (e, en, es, r, rn, rs), r, "shard_t2")
    check_coarse(ec, ecn, ecs, r, "shard_t2")
    z = shard_row_t2(_strip_row(coef), [(e, en, es)], [(r, rn, rs)],
                     [(ec, ecn, ecs)], omega=omega, nu=nu, over=over)
    shard_t2.launches += 1
    return z[0]


shard_row_t1.launches = 0
shard_row_t2.launches = 0
shard_t1.launches = 0
shard_t2.launches = 0
