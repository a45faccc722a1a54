"""K7: up to ``k`` multigrid-preconditioned CG iterations per volume on the
banded 3D engine, each iteration three passes over level 0 -- the CUDA
kernel (``csrc/cgstep3d.cu`` over ``csrc/vcycle3d.cuh`` and
``csrc/cgscalars.cuh``) and its plain PyTorch version.

Replaces ``effectivediffusivityfvm_tpu/ops/kernels/cgstep3d.py``
(``cg_steps3d_tiled``: ``_pass_a3``, ``_pass_b3``, ``_pass_c3``).  The
contract per volume:

* ``active <= 0``: frozen -- nothing is done and ``k_done = 0``;
* ``live = active > 0 and stop < sum|r_in| < hi``; while ``i < k`` and
  live: ``beta = rz/rz_prev`` (0 at ``i = 0`` or if ``rz_prev <= 0``),
  ``p = z + beta p`` (``z = p`` on entry), ``q = A p``, ``alpha =
  rz/<p,q>`` (0 unless ``<p,q> > 0``), ``x += alpha p``, ``r -= alpha q``,
  ``z`` = the banded cycle of ``r`` (T1, the whole cycle on ``levels[1:]``,
  T2), ``rz = <r, z>``, ``k_done += 1``, ``live = stop < sum|r| < hi``; a
  volume that is not live keeps its ``z``;
* no refresh: the caller refreshes between windows.

``A`` is the level-0 stencil with the diagonal rebuilt as ``1/diag_inv``.
Matrix-free (``d_field`` = the padded D, ``geom = (fx, fy, fz, bcf,
nxr)``): level 0's ``a_w``/``a_n``/``a_u``/``diag_inv`` are rebuilt from D
by :func:`~.vcycle3d.coeffs_from_d3` (pads get ``diag_inv`` 0, not the
stored identity); x, r and p of every volume are first multiplied by ``(D
> 0)``, and ``z`` is 0 where ``D == 0``; levels 1+ stay stored.  Both
versions update x, r and p in place and return them.

The kernel runs an iteration as three z-marching passes over level 0
(``csrc/march3d.cuh``; X and Z are K6's DOWN and UP passes with the CG
update, ``csrc/levelpass3d.cuh``) around K6's whole cycle on
``levels[1:]``; :func:`march3_plan` is the Python twin of the passes' tile
and segment rule and shared-memory sizes, K6's included.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..fvm import guarded_inverse
from ..fvm3d import StencilCoeffs3D
from .cgstep import batch_sum
from .vcycle import check_plane, smoothing_schedule, weights
from .vcycle3d import (Level3Args, _check_banded, _device_ok, _nbsum3,
                       coarse_tail3, coeffs_from_d3, post3_reference,
                       pre3_reference)

__all__ = ["cg_steps3d_reference", "cg_steps3d", "march3_plan"]

# The z-marching rule of the kernel's passes (csrc/march3d.cuh, twin of
# march::seg_len and march::smem_bytes): (y, x) tiles of 16 x 32 cells in
# float32, 8 x 32 in float64; z cut into even segments so that a volume
# gives at least MARCH3_TARGET_CTAS CTAs (one wave of two an SM on the
# H100's 132 SMs) where each segment keeps at least max(8, 4 nu) slices.
MARCH3_TX = 32
MARCH3_TARGET_CTAS = 256
MARCH3_PD = 1                    # slices staged ahead of the one in use
MARCH3_LEVEL_MIN_SEG = 2         # K6's level passes: the shortest segment
SMEM_BLOCK_MAX = 232448          # the H100's opt-in shared memory a block
SMEM_SM = 233472                 # shared memory an SM (228 KiB)
# K7's passes P, X, Z and K6's level passes DOWN (X without the CG
# update) and UP (Z without the pin and the dot product), by their index in
# the C rule
PASSES = ("P", "X", "Z", "DOWN", "UP")


def _march3_smem(pass_i: int, itemsize: int, nu: int, mf: bool) -> int:
    ty = 8 if itemsize == 8 else 16
    h = 1 if pass_i == 0 else nu
    win = (ty + 2 * h) * (MARCH3_TX + 2 * h)
    dwin = (ty + 2 * h + 2) * (MARCH3_TX + 2 * h + 2)
    pd = MARCH3_PD
    coef = (2 if pass_i == 0 else nu + 1) + pd
    fields = ((3 + pd) + (1 + pd),
              (nu + 1 + pd) + (1 + pd) + 3 + 3 * (nu - 1),
              (3 + pd) + (nu + 1 + pd) + 3 * (nu - 1),
              (nu + 1 + pd) + 3 + 3 * (nu - 1),
              (3 + pd) + (nu + 1 + pd) + 3 * (nu - 1))[pass_i]
    tiles = (2 * (1 + pd) + 1 if pass_i == 1 else 1 if pass_i == 3
             else nu + 1 if pass_i == 2 and mf else 0)
    coarse = ((1 + pd) * (ty // 2 + h + 1) * (MARCH3_TX // 2 + h + 1)
              if pass_i in (2, 4) else 0)
    return itemsize * ((4 * coef + fields) * win + tiles * ty * MARCH3_TX
                       + coarse + ((2 + pd) * dwin if mf else 0))


def march3_plan(shape, itemsize: int, nu: int) -> dict:
    """The kernel's tiling of a level-0 shape ``(nz, ny, nx)``: ``tile``
    (rows, columns), ``tiles`` a plane, ``seg_len`` (slices a z-segment of
    K7's passes, even), ``segments``, ``ctas`` a volume, the same for K6's
    level passes (``level_seg_len``, ``level_segments``, ``level_ctas``:
    segments as short as 2 slices), and ``smem[(pass, mf)]`` the
    dynamic shared memory in bytes of K7's pass "P", "X" or "Z" (stored or
    matrix-free level 0) and of K6's "DOWN" or "UP" (stored, ``mf``
    False).  A function of the shape, the element size and nu alone, equal
    to the C rule (a card test holds them equal)."""
    nz, ny, nx = (int(v) for v in shape)
    ty = 8 if itemsize == 8 else 16
    tiles = -(-ny // ty) * -(-nx // MARCH3_TX)

    def seg_len(shortest):
        nseg = min(-(-MARCH3_TARGET_CTAS // tiles), max(1, nz // shortest))
        n = -(-nz // nseg)
        return n + (n & 1)

    seg, level_seg = seg_len(max(8, 4 * nu)), seg_len(MARCH3_LEVEL_MIN_SEG)
    smem = {(name, mf): _march3_smem(i, itemsize, nu, mf)
            for i, name in enumerate(PASSES)
            for mf in ((False, True) if i < 3 else (False,))}
    return dict(tile=(ty, MARCH3_TX), tiles=tiles, seg_len=seg,
                segments=-(-nz // seg), ctas=tiles * -(-nz // seg),
                level_seg_len=level_seg, level_segments=-(-nz // level_seg),
                level_ctas=tiles * -(-nz // level_seg), smem=smem)


def _check_args(levels, x, nu, d_field, geom):
    _check_banded(levels, x, nu)
    if d_field is not None and geom is None:
        raise ValueError("cg_steps3d: d_field requires geom")


def cg_steps3d_reference(levels: Sequence[StencilCoeffs3D], x, r, p, rz,
                         active, stop, hi, k: int, *, omega=0.8, nu: int = 2,
                         coarse_iters: int = 32, over: float = 1.8,
                         d_field=None, geom=None):
    """Plain PyTorch version of :func:`cg_steps3d` (same arguments, same
    outputs, same in-place update of x/r/p)."""
    _check_args(levels, x, nu, d_field, geom)
    ws = smoothing_schedule(omega, nu)
    mg = dict(omega=omega, nu=nu, coarse_iters=coarse_iters, over=over)
    shape_c = tuple(levels[1].diag.shape[-3:])
    c0 = levels[0]
    dt = x.dtype
    if d_field is not None:
        d = d_field.to(dt)
        coef = coeffs_from_d3(d, geom)
        ind = (d > 0).to(dt)
        x.mul_(ind)
        r.mul_(ind)
        p.mul_(ind)
    else:
        coef = (c0.a_w, c0.a_n, c0.a_u, c0.diag_inv)
    aw, an, au, di = coef
    dg = guarded_inverse(di)

    def where4(m, a, b):
        return torch.where(m[:, None, None, None], a, b)

    xs, rs, ps = x, r, p
    stop, hi = stop.to(dt), hi.to(dt)
    rz_c = rz.to(dt).clone()
    rz_p = rz_c.clone()
    sr = batch_sum(torch.abs(r))
    live = (active > 0) & (sr > stop) & (sr < hi)
    k_done = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    z = p
    for i in range(k):
        if not bool(live.any()):
            break
        cg_steps3d_reference.iterations += 1
        beta = torch.where(live & (rz_p > 0) & (i > 0),
                           rz_c / torch.where(rz_p > 0, rz_p, 1.0), 0.0)
        p = where4(live, z + beta[:, None, None, None] * p, p)
        q = dg * p - _nbsum3(aw, an, au, p)
        pap = batch_sum(p * q)
        alpha = torch.where(live & (pap > 0),
                            rz_c / torch.where(pap > 0, pap, 1.0), 0.0)
        a4 = alpha[:, None, None, None]
        x = where4(live, x + a4 * p, x)
        r = where4(live, r - a4 * q, r)
        sr_out = batch_sum(torch.abs(r))
        e, rc = pre3_reference(coef, r, ws, shape_c)
        ec = coarse_tail3(levels, rc, plain=True, **mg)
        z_new = post3_reference(coef, e, r, ec, ws, over)
        if d_field is not None:
            z_new = torch.where(d > 0, z_new, torch.zeros_like(z_new))
        rz_out = batch_sum(r * z_new)
        sr = torch.where(live, sr_out, sr)
        rz_p = torch.where(live, rz_c, rz_p)
        rz_c = torch.where(live, rz_out, rz_c)
        z = where4(live, z_new, z)
        k_done = k_done + live.to(torch.int32)
        live = live & (sr > stop) & (sr < hi)
    xs.copy_(x)
    rs.copy_(r)
    ps.copy_(p)
    return xs, rs, ps, rz_c, k_done


def cg_steps3d(levels: List[StencilCoeffs3D], x, r, p, rz, active, stop, hi,
               k: int, *, omega=0.8, nu: int = 2, coarse_iters: int = 32,
               over: float = 1.8, d_field=None, geom=None):
    """Run up to ``k`` banded 3D MGCG iterations on a padded ``(B, nz, ny,
    nx)`` batch.

    Args:
      levels: ``build_hierarchy_3d(..., pad_levels=True)`` of an operator
        padded to ``pad_shape_3d``, volumes ``(B, nz_l, ny_l, nx_l)``.
      x, r, p: CG state ``(B, nz, ny, nx)``, updated in place.
      rz: ``<r, z>`` per volume, ``(B,)``.
      active: ``> 0`` iterates, ``<= 0`` frozen, ``(B,)``.
      stop / hi: per-volume early-exit and divergence thresholds on
        ``sum|r|``, ``(B,)``.
      k: iteration cap (host integer).
      d_field, geom: matrix-free level 0 (see the module docstring).
    Returns:
      ``(x, r, p, rz, k_done)``; ``k_done`` is int32 ``(B,)``.

    A CPU tensor runs the plain version; a CUDA tensor launches the CUDA
    kernel (float32 or float64, ``1 <= nu <= HALO_Z - 1``) or raises.
    """
    kw = dict(omega=omega, nu=nu, coarse_iters=coarse_iters, over=over,
              d_field=d_field, geom=geom)
    if not _device_ok(x, "cg_steps3d"):
        return cg_steps3d_reference(levels, x, r, p, rz, active, stop, hi, k,
                                    **kw)
    from ._build import check, load_library

    _check_args(levels, x, nu, d_field, geom)
    if k < 0:
        raise ValueError(f"cg_steps3d: k={k} must be >= 0")
    lib = load_library()
    la = Level3Args(levels, x)
    bsz = x.shape[0]
    vol = (bsz,) + la.shapes[0]
    for name, t in (("x", x), ("r", r), ("p", p)):
        check_plane(t, name, vol, x)
    if d_field is not None:
        check_plane(d_field, "d_field", vol, x)
        fx, fy, fz, bcf = (float(g) for g in geom[:4])
        nxr = int(geom[4])
        d_ptr = d_field.data_ptr()
    else:
        fx = fy = fz = bcf = 0.0
        nxr, d_ptr = 0, None
    rz = rz.to(x.dtype).contiguous().clone()
    active, stop, hi = (t.to(x.dtype).contiguous() for t in (active, stop, hi))
    for name, t in (("rz", rz), ("active", active), ("stop", stop),
                    ("hi", hi)):
        check_plane(t, name, (bsz,), x)
    k_done = torch.empty(bsz, dtype=torch.int32, device=x.device)
    per_image = lib.deff_cg3d_scratch_elems(la.n_levels, la.nz, la.ny, la.nx,
                                            x.element_size())
    scratch = torch.empty(bsz * per_image, dtype=x.dtype, device=x.device)
    iscratch = torch.empty(2 * bsz, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, f"deff_cg_steps3d_{la.suffix}")(
            bsz, la.n_levels, la.nz, la.ny, la.nx, la.aw, la.an, la.au,
            la.dinv, d_ptr, fx, fy, fz, bcf, nxr, x.data_ptr(), r.data_ptr(),
            p.data_ptr(), rz.data_ptr(), active.data_ptr(), stop.data_ptr(),
            hi.data_ptr(), int(k), k_done.data_ptr(), weights(omega, nu), nu,
            coarse_iters, float(over), scratch.data_ptr(),
            iscratch.data_ptr(), stream)
    check(status, "cg_steps3d")
    cg_steps3d.launches += 1
    return x, r, p, rz, k_done


cg_steps3d.launches = 0
cg_steps3d_reference.iterations = 0
