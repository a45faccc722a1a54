"""K6: the 7-point voxel V(nu, nu) cycle -- the CUDA kernels
(``csrc/vcycle3d.cuh``, entries in ``csrc/vcycle3d.cu``) and their plain
PyTorch versions -- plus the banded engine's padded shape and the
matrix-free rebuild of level 0 from the diffusivity volume.

Replaces ``effectivediffusivityfvm_tpu/ops/kernels/vcycle3d.py``:
``v_cycle3d_pallas`` (the whole cycle, body ``_cycle3d_value``) and
``v_cycle3d_tiled`` (``_t1_kernel3``, ``_t2_kernel3`` and ``coarse_tail3``).
What is computed is the same, step for step:

* the stencil is rebuilt from ``a_w``/``a_n``/``a_u`` only, as
  ``aw x[w] + (aw x)[e] + an x[n] + (an x)[s] + au x[u] + (au x)[d]`` (the
  symmetric assembly: unmasked, or ``symmetric=True``), with zero outside
  the volume;
* the diagonal inside the cycle is ``1/diag_inv`` (0 where diag_inv is 0);
* pre-smoothing: ``e = (ws[0] dinv) r``, then damped Jacobi ``(1 - w) e +
  (w (r + nbsum(e))) dinv`` for ``ws[1:]``; post-smoothing runs
  ``reversed(ws)``; the coarsest level runs ``coarse_iters`` sweeps at
  ``ws[-1]`` from zero;
* restriction is a 2x2x2 block sum, z pairs first, then y pairs, then x
  pairs; a padded coarse cell receives 0; prolongation is piecewise
  constant (``e_c[k/2, i/2, j/2]``), scaled by ``over``.

The banded cycle is T1 (pre-smoothing, residual and restriction on level
0), the whole cycle on ``levels[1:]`` as the coarse tail, and T2
(prolongation and post-smoothing on level 0).  On the TPU the fine level
streamed in z-slabs of ``band`` slices with ``HALO_Z`` halo slices because
a slab had to fit VMEM, and the tail recursed or fell back to XLA by size;
here T1 and T2 run over the whole volume and the tail is always the whole
cycle -- the same arithmetic in the same order.  :func:`band_z_for`,
:func:`pad_shape_3d` and :func:`pad_op_3d` are the JAX package's, copied
exactly: the band sets no tiling on the card, but the padded shape fixes
the hierarchy and with it the iteration counts.

On a CUDA tensor :func:`v_cycle3d` and :func:`v_cycle3d_tiled` launch the
kernels (or raise); on a CPU tensor they run the plain versions.  The
kernel runs each level of the cycle above the bottom of the pyramid, and
T1 and T2, as z-marching tile passes (down: the pre-sweeps, residual and
restriction; up: the prolongation and post-sweeps; ``nu <= MAX_NU3``) and
the bottom, from :func:`cycle3_resident_from` down, in one launch with
each volume's pyramid resident in one CTA's shared memory.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..fvm import guarded_inverse
from ..fvm3d import StencilCoeffs3D
from .vcycle import _CTYPE, check_plane, smoothing_schedule, weights

__all__ = ["HALO_Z", "MAX_NU3", "band_z_for", "pad_shape_3d", "pad_op_3d",
           "Level3Args",
           "coeffs_from_d3", "v_cycle3d_reference", "pre3_reference",
           "post3_reference", "v_cycle3d_tiled_reference", "v_cycle3d",
           "v_cycle3d_tiled", "cycle3_resident_from", "cycle3_launches"]

HALO_Z = 4     # the TPU engine's halo slices (covers nu <= 3)
MAX_NU3 = 3    # sweeps a leg the kernel's level passes take (halo nu)
RESIDENT3_SMEM = 231424  # bytes of one CTA the resident bottom's volumes take
RESIDENT3_LEVELS = 16    # levels the resident bottom holds at most


def cycle3_resident_from(shapes, itemsize: int) -> int:
    """The level from which K6 runs the rest of the pyramid resident in one
    CTA per volume: the first level ``l`` whose volumes from ``l`` down --
    ``a_w``, ``a_n``, ``a_u``, ``diag_inv``, right-hand side and correction
    of each level, plus one ping-pong volume of level ``l``'s size,
    ``itemsize`` bytes a cell -- fit ``RESIDENT3_SMEM`` bytes in at most
    ``RESIDENT3_LEVELS`` levels; ``len(shapes)`` when even the coarsest
    level does not fit (its sweeps then run from global memory).  Shape and
    element size alone decide it; the kernel (``csrc/vcycle3d.cuh``)
    applies the same rule.  On config 5's hierarchy (256^3, min_size 4) it
    starts the cycle on ``levels[1:]`` at 16^3 in float32 and at 8^3 in
    float64."""
    cells = 0
    n_lv = len(shapes)
    for l in range(n_lv - 1, -1, -1):
        n = shapes[l][0] * shapes[l][1] * shapes[l][2]
        cells += 6 * n
        if ((cells + n) * itemsize > RESIDENT3_SMEM
                or n_lv - l > RESIDENT3_LEVELS):
            return l + 1
    return 0


def cycle3_launches(shapes, itemsize: int) -> int:
    """Kernel launches of one K6 whole cycle over the 3D levels ``shapes``:
    two tile passes for each level above the resident bottom, and one for
    the bottom (or, when not even the coarsest level fits, for the coarsest
    level's sweeps)."""
    lb = cycle3_resident_from(shapes, itemsize)
    return 2 * min(lb, len(shapes) - 1) + 1


def band_z_for(nz: int, ny: int, nx: int, itemsize: int = 4,
               fields: int = 18) -> int:
    """Largest z-band whose T1/T2 working set (``fields`` window fields incl.
    double-buffering; ~18 for the stored-coefficient passes, ~12 for the
    matrix-free ones) fits the TPU kernel's VMEM budget.  Always a multiple
    of HALO_Z."""
    budget = 100 * 1024 * 1024
    plane = ny * nx * itemsize
    for bz in (64, 32, 16, 8, 4):
        if fields * (bz + 2 * HALO_Z) * plane < budget:
            if bz >= nz:            # one band covers the volume; keep the
                return -(-nz // HALO_Z) * HALO_Z   # block quantum anyway
            return bz
    return 4


def pad_shape_3d(nz: int, ny: int, nx: int, band: int) -> tuple:
    """Banded fine-level padded shape: nz to a band multiple, ny/nx even."""
    return -(-nz // band) * band, ny + ny % 2, nx + nx % 2


def pad_op_3d(c: StencilCoeffs3D, pz: int, py: int, px: int) -> StencilCoeffs3D:
    """Pad by trailing decoupled identity voxels (diag 1, couplings 0, b 0)."""
    if not (pz or py or px):
        return c
    pad = (0, px, 0, py, 0, pz)

    def z(a):
        return F.pad(a, pad)

    diag = F.pad(c.diag, pad, value=1.0)
    return StencilCoeffs3D(
        a_w=z(c.a_w), a_e=z(c.a_e), a_n=z(c.a_n), a_s=z(c.a_s),
        a_u=z(c.a_u), a_d=z(c.a_d), diag=diag,
        diag_inv=guarded_inverse(diag), b=z(c.b))


def coeffs_from_d3(d_pad: torch.Tensor, geom):
    """Level-0 ``(a_w, a_n, a_u, diag_inv)`` of the padded ``(..., nz, ny,
    nx)`` D, term for term as the TPU kernel rebuilds them
    (``_coeffs_from_dwin``): face conductances by the guarded product form
    ``(2a) b / (a + b)`` times ``fx``/``fy``/``fz`` (0 where ``a + b <=
    0``), ``diag = a_w + a_e + a_n + a_s + a_u + a_d`` plus ``D * bcf`` at
    the real columns 0 and ``nxr - 1``, ``diag_inv = 1/diag`` where ``diag >
    0``, else 0.  ``geom = (fx, fy, fz, bcf, nxr)``.  Assembly's
    reciprocal-form mean differs by 1-2 ulp."""
    fx, fy, fz, bcf, nxr = geom
    d = d_pad

    def hm(a, b):
        s = a + b
        pos = s > 0
        return torch.where(pos, (2.0 * a) * b / torch.where(pos, s, 1.0),
                           torch.zeros_like(s))

    hx = hm(d[..., :, :, :-1], d[..., :, :, 1:]) * fx
    hy = hm(d[..., :, :-1, :], d[..., :, 1:, :]) * fy
    hz = hm(d[..., :-1, :, :], d[..., 1:, :, :]) * fz
    aw = F.pad(hx, (1, 0))
    ae = F.pad(hx, (0, 1))
    an = F.pad(hy, (0, 0, 1, 0))
    as_ = F.pad(hy, (0, 0, 0, 1))
    au = F.pad(hz, (0, 0, 0, 0, 1, 0))
    ad = F.pad(hz, (0, 0, 0, 0, 0, 1))
    diag = aw + ae + an + as_ + au + ad
    col = torch.arange(d.shape[-1], device=d.device)
    edge = (col == 0) | (col == nxr - 1)
    diag = diag + torch.where(edge, d * bcf, torch.zeros_like(d))
    return aw, an, au, guarded_inverse(diag)


# ---------------------------------------------------------------- plain


def _nbsum3(aw, an, au, x):
    """Neighbour sum of the symmetric 7-point stencil from the west, north
    and up planes, zero outside the volume."""
    xw = F.pad(x[..., :, :, :-1], (1, 0))
    xn = F.pad(x[..., :, :-1, :], (0, 0, 1, 0))
    xu = F.pad(x[..., :-1, :, :], (0, 0, 0, 0, 1, 0))
    east = F.pad((aw * x)[..., :, :, 1:], (0, 1))
    south = F.pad((an * x)[..., :, 1:, :], (0, 0, 0, 1))
    down = F.pad((au * x)[..., 1:, :, :], (0, 0, 0, 0, 0, 1))
    return aw * xw + east + an * xn + south + au * xu + down


def _smooth3(aw, an, au, di, x, b, w):
    return (1.0 - w) * x + w * (b + _nbsum3(aw, an, au, x)) * di


def _restrict3(res, shape_c):
    """2x2x2 block sum (z pairs, then y pairs, then x pairs), zero-padded to
    the coarse level's shape."""
    t = res[..., 0::2, :, :] + res[..., 1::2, :, :]
    t = t[..., :, 0::2, :] + t[..., :, 1::2, :]
    t = t[..., :, :, 0::2] + t[..., :, :, 1::2]
    nzc, nyc, nxc = shape_c
    return F.pad(t, (0, nxc - t.shape[-1], 0, nyc - t.shape[-2],
                     0, nzc - t.shape[-3]))


def _prolong3(ec, shape_f):
    """Piecewise-constant injection onto the fine shape (drops padded
    coarse tails)."""
    nz, ny, nx = shape_f
    e = ec[..., :(nz + 1) // 2, :(ny + 1) // 2, :(nx + 1) // 2]
    for dim in (-3, -2, -1):
        e = e.repeat_interleave(2, dim=dim)
    return e[..., :nz, :ny, :nx]


def _shapes(levels):
    return [tuple(c.diag.shape[-3:]) for c in levels]


def _check_even(shapes):
    for s in shapes[:-1]:
        if any(v % 2 for v in s):
            raise ValueError("the V-cycle needs even level dims (build the "
                             "hierarchy with pad_levels=True)")


def v_cycle3d_reference(levels: Sequence[StencilCoeffs3D], r: torch.Tensor, *,
                        omega=0.8, nu: int = 1, coarse_iters: int = 32,
                        over: float = 1.8) -> torch.Tensor:
    """Plain PyTorch whole V(nu, nu) cycle: ``(B, nz, ny, nx) -> same``."""
    shapes = _shapes(levels)
    _check_even(shapes)
    ws = smoothing_schedule(omega, nu)
    lvl = [(c.a_w, c.a_n, c.a_u, c.diag_inv, guarded_inverse(c.diag_inv))
           for c in levels]

    def smooth(l, x, b, w):
        aw, an, au, di, _ = lvl[l]
        return _smooth3(aw, an, au, di, x, b, w)

    rs = [r]
    es = []
    for l in range(len(levels) - 1):
        aw, an, au, di, dg = lvl[l]
        e = ws[0] * di * rs[l]
        for w in ws[1:]:
            e = smooth(l, e, rs[l], w)
        res = rs[l] - (dg * e - _nbsum3(aw, an, au, e))
        es.append(e)
        rs.append(_restrict3(res, shapes[l + 1]))

    lc = len(levels) - 1
    e = torch.zeros_like(rs[lc])
    for _ in range(coarse_iters):
        e = smooth(lc, e, rs[lc], ws[-1])

    for l in range(len(levels) - 2, -1, -1):
        e = es[l] + over * _prolong3(e, shapes[l])
        for w in reversed(ws):
            e = smooth(l, e, rs[l], w)
    return e


def pre3_reference(coef, r, ws, shape_c):
    """Plain T1: ``(e, rc)`` for level-0 planes ``coef = (aw, an, au,
    dinv)`` and ``r`` ``(B, nz, ny, nx)``; ``rc`` lies on the coarse shape
    ``shape_c`` (``levels[1]``), zero where no fine block maps."""
    aw, an, au, di = coef
    e = ws[0] * di * r
    for w in ws[1:]:
        e = _smooth3(aw, an, au, di, e, r, w)
    res = r - (guarded_inverse(di) * e - _nbsum3(aw, an, au, e))
    return e, _restrict3(res, shape_c)


def post3_reference(coef, e, r, ec, ws, over):
    """Plain T2: ``z`` from the pre-smoothed ``e``, ``r`` and the coarse
    correction ``ec`` on ``levels[1]``'s shape."""
    aw, an, au, di = coef
    e = e + over * _prolong3(ec, tuple(e.shape[-3:]))
    for w in reversed(ws):
        e = _smooth3(aw, an, au, di, e, r, w)
    return e


def _check_banded(levels, r, nu):
    if len(levels) < 2:
        raise ValueError("the banded cycle needs at least two levels")
    if nu < 1 or nu > HALO_Z - 1:
        raise ValueError(f"the banded 3D cycle needs 1 <= nu <= {HALO_Z - 1}, "
                         f"got {nu}")
    nz, ny, nx = r.shape[-3:]
    want = (nz // 2, ny // 2, nx // 2)
    got = tuple(levels[1].diag.shape[-3:])
    if nz % 2 or ny % 2 or nx % 2 or any(g < w for g, w in zip(got, want)):
        raise ValueError(f"the banded cycle needs even level-0 dims and "
                         f"levels[1] of at least {want}, got {(nz, ny, nx)} "
                         f"and {got}")


def coarse_tail3(levels, rc, *, omega, nu, coarse_iters, over, plain=False,
                 tail_args=None):
    """The coarse correction of the restricted residual ``rc`` (on
    ``levels[1]``'s shape): the whole cycle on ``levels[1:]`` (its plain
    version if ``plain``; ``tail_args``, the :class:`Level3Args` of
    ``levels[1:]``, passed on to the kernel)."""
    mg = dict(omega=omega, nu=nu, coarse_iters=coarse_iters, over=over)
    if plain:
        return v_cycle3d_reference(levels[1:], rc, **mg)
    return v_cycle3d(levels[1:], rc, level_args=tail_args, **mg)


def v_cycle3d_tiled_reference(levels, r, *, omega=0.8, nu: int = 1,
                              coarse_iters: int = 32,
                              over: float = 1.8) -> torch.Tensor:
    """Plain PyTorch banded V(nu, nu) cycle: T1, the whole cycle on
    ``levels[1:]``, T2."""
    _check_banded(levels, r, nu)
    ws = smoothing_schedule(omega, nu)
    c0 = levels[0]
    coef = (c0.a_w, c0.a_n, c0.a_u, c0.diag_inv)
    e, rc = pre3_reference(coef, r, ws, tuple(levels[1].diag.shape[-3:]))
    ec = coarse_tail3(levels, rc, omega=omega, nu=nu,
                      coarse_iters=coarse_iters, over=over, plain=True)
    return post3_reference(coef, e, r, ec, ws, over)


# ---------------------------------------------------------------- CUDA path


class Level3Args:
    """The hierarchy as the C entries take it: shape arrays and pointer
    arrays of the ``a_w``/``a_n``/``a_u``/``diag_inv`` volumes.  Holds the
    ctypes buffers for as long as a launch may read them."""

    def __init__(self, levels: Sequence[StencilCoeffs3D], like: torch.Tensor):
        if like.dtype not in _CTYPE:
            raise ValueError(f"kernels take float32 or float64, not {like.dtype}")
        bsz = like.shape[0]
        shapes = _shapes(levels)
        _check_even(shapes)
        n = len(levels)
        self.n_levels = n
        self.shapes = shapes
        for s in shapes:
            if s[0] * s[1] * s[2] >= 2 ** 31:
                raise ValueError(f"a level of {s} voxels is past the kernels' "
                                 "32-bit cell index")
        self.nz = (ctypes.c_int * n)(*(s[0] for s in shapes))
        self.ny = (ctypes.c_int * n)(*(s[1] for s in shapes))
        self.nx = (ctypes.c_int * n)(*(s[2] for s in shapes))
        ptrs = {f: [] for f in ("a_w", "a_n", "a_u", "diag_inv")}
        for l, (c, s) in enumerate(zip(levels, shapes)):
            for f in ptrs:
                vol = getattr(c, f)
                check_plane(vol, f"levels[{l}].{f}", (bsz,) + s, like)
                ptrs[f].append(vol.data_ptr())
        self.aw = (ctypes.c_void_p * n)(*ptrs["a_w"])
        self.an = (ctypes.c_void_p * n)(*ptrs["a_n"])
        self.au = (ctypes.c_void_p * n)(*ptrs["a_u"])
        self.dinv = (ctypes.c_void_p * n)(*ptrs["diag_inv"])
        self.suffix = _CTYPE[like.dtype]


def _device_ok(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.dtype not in _CTYPE:
        raise ValueError(f"kernels take float32 or float64, not {t.dtype}")
    return True


def v_cycle3d(levels: List[StencilCoeffs3D], r: torch.Tensor, *, omega=0.8,
              nu: int = 1, coarse_iters: int = 32,
              over: float = 1.8, level_args=None) -> torch.Tensor:
    """One whole V(nu, nu) cycle ``z = M r`` on a ``(B, nz, ny, nx)`` batch.

    ``levels`` is ``build_hierarchy_3d(..., pad_levels=True)`` with volumes
    ``(B, nz_l, ny_l, nx_l)``.  A CPU tensor runs the plain version; a CUDA
    tensor launches the CUDA kernels (float32 or float64, ``nu <=
    MAX_NU3``): :func:`cycle3_launches` of them.  ``level_args`` (a
    :class:`Level3Args` of ``levels``, kept by a caller that cycles again
    and again) spares building the pointer tables each call.
    """
    if nu < 1:
        raise ValueError(f"v_cycle3d: nu={nu} must be >= 1")
    if not _device_ok(r, "v_cycle3d"):
        return v_cycle3d_reference(levels, r, omega=omega, nu=nu,
                                   coarse_iters=coarse_iters, over=over)
    if nu > MAX_NU3:
        raise ValueError(f"v_cycle3d: the kernel takes nu <= {MAX_NU3}, "
                         f"got {nu}")
    from ._build import check, load_library

    lib = load_library()
    la = Level3Args(levels, r) if level_args is None else level_args
    bsz = r.shape[0]
    check_plane(r, "r", (bsz,) + la.shapes[0], r)
    z = torch.empty_like(r)
    per_image = lib.deff_cycle3_scratch_elems(la.n_levels, la.nz, la.ny,
                                              la.nx)
    scratch = torch.empty(bsz * per_image, dtype=r.dtype, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, f"deff_v_cycle3d_{la.suffix}")(
            bsz, la.n_levels, la.nz, la.ny, la.nx, la.aw, la.an, la.au,
            la.dinv, r.data_ptr(), z.data_ptr(), scratch.data_ptr(),
            weights(omega, nu), nu, coarse_iters, float(over), stream)
    check(status, "v_cycle3d")
    v_cycle3d.launches += 1
    return z


v_cycle3d.launches = 0


def v_cycle3d_tiled(levels: List[StencilCoeffs3D], r: torch.Tensor, *,
                    omega=0.8, nu: int = 1, coarse_iters: int = 32,
                    over: float = 1.8, tail_args=None) -> torch.Tensor:
    """One banded V(nu, nu) cycle ``z = M r`` on a ``(B, nz, ny, nx)``
    batch: T1 on level 0, :func:`v_cycle3d` on ``levels[1:]``, T2.

    ``levels`` is ``build_hierarchy_3d(..., pad_levels=True)`` of an
    operator padded to :func:`pad_shape_3d`; ``1 <= nu <= HALO_Z - 1``.  A
    CPU tensor runs the plain version; a CUDA tensor launches the kernels
    (float32 or float64) or raises: T1 and T2 one tile pass each, the tail
    :func:`cycle3_launches` of ``levels[1:]`` (``tail_args``: their
    :class:`Level3Args`, kept by a caller that cycles again and again).
    """
    if not _device_ok(r, "v_cycle3d_tiled"):
        return v_cycle3d_tiled_reference(levels, r, omega=omega, nu=nu,
                                         coarse_iters=coarse_iters, over=over)
    from ._build import check, load_library

    _check_banded(levels, r, nu)
    lib = load_library()
    bsz = r.shape[0]
    shape0 = tuple(r.shape[1:])
    shape1 = tuple(levels[1].diag.shape[-3:])
    c0 = levels[0]
    for name, t in (("r", r), ("a_w", c0.a_w), ("a_n", c0.a_n),
                    ("a_u", c0.a_u), ("diag_inv", c0.diag_inv)):
        check_plane(t, name, (bsz,) + shape0, r)
    e = torch.empty_like(r)
    rc = torch.empty((bsz,) + shape1, dtype=r.dtype, device=r.device)
    z = torch.empty_like(r)
    ws = weights(omega, nu)
    sfx = _CTYPE[r.dtype]
    dims0 = (bsz,) + shape0
    coefs = (c0.a_w.data_ptr(), c0.a_n.data_ptr(), c0.a_u.data_ptr(),
             c0.diag_inv.data_ptr())
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, f"deff_t1_3d_{sfx}")(
            *dims0, *shape1, *coefs, r.data_ptr(), e.data_ptr(),
            rc.data_ptr(), ws, nu, stream),
            "v_cycle3d_tiled (T1)")
        ec = coarse_tail3(levels, rc, omega=omega, nu=nu,
                          coarse_iters=coarse_iters, over=over,
                          tail_args=tail_args)
        check(getattr(lib, f"deff_t2_3d_{sfx}")(
            *dims0, *shape1, *coefs, e.data_ptr(), ec.data_ptr(),
            r.data_ptr(), z.data_ptr(), ws, nu, float(over), stream),
            "v_cycle3d_tiled (T2)")
    v_cycle3d_tiled.launches += 1
    return z


v_cycle3d_tiled.launches = 0
