"""K2: one whole V(nu, nu) multigrid cycle ``z = M r`` over the padded-even
hierarchy — the CUDA kernel (``csrc/vcycle.cuh``, entries in
``csrc/vcycle.cu``) and its plain PyTorch version.

Replaces ``effectivediffusivityfvm_tpu/ops/kernels/vcycle_vmem.py``
(``v_cycle_pallas``, body ``_cycle_value``).  What is computed is the same,
step for step:

* the stencil is rebuilt from ``a_w``/``a_n`` only (east term
  ``a_w[i, j+1] x[i, j+1]``, south term ``a_n[i+1, j] x[i+1, j]``), which
  holds for the symmetric assembly (unmasked, or ``symmetric=True``);
* the diagonal inside the cycle is ``1/diag_inv`` (0 where diag_inv is 0),
  not ``diag`` — the two differ on coarse cells that hit the ``coarsen``
  floor;
* pre-smoothing: ``e = ws[0] dinv r``, then damped Jacobi for ``ws[1:]``;
  post-smoothing runs ``reversed(ws)``; the coarsest level runs
  ``coarse_iters`` sweeps at ``ws[-1]`` from zero;
* restriction is a 2x2 block sum (rows first, then columns), a padded
  coarse row or column receives 0; prolongation is piecewise constant,
  scaled by ``over``.

On a CUDA tensor :func:`v_cycle` launches the kernel (or raises); on a CPU
tensor it runs :func:`v_cycle_reference`.  The kernel runs each level above
the bottom of the pyramid as two shared-memory tile passes (down: the pre-
sweeps, residual and restriction; up: the prolongation and post-sweeps) and
the bottom, from :func:`cycle_resident_from` down, in one launch with each
image's pyramid resident in one CTA's shared memory.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..fvm import StencilCoeffs, guarded_inverse

__all__ = ["smoothing_schedule", "v_cycle_reference", "v_cycle",
           "cycle_resident_from", "cycle_launches", "MAX_NU"]

MAX_NU = 8              # sweeps a leg the kernel's tile passes take
RESIDENT_SMEM = 231424  # bytes of one CTA the resident bottom's planes take
RESIDENT_LEVELS = 16    # levels the resident bottom holds at most


def cycle_resident_from(shapes, itemsize: int) -> int:
    """The level from which K2 runs the rest of the pyramid resident in one
    CTA per image: the first level ``l`` whose planes from ``l`` down --
    ``a_w``, ``a_n``, ``diag_inv``, right-hand side and correction of each
    level, plus one ping-pong plane of level ``l``'s size, ``itemsize`` bytes
    a cell -- fit ``RESIDENT_SMEM`` bytes in at most ``RESIDENT_LEVELS``
    levels; ``len(shapes)`` when even the coarsest level does not fit (its
    sweeps then run from global memory).  Shape and element size alone
    decide it, as the JAX package's ``vcycle_fits_vmem`` does; the kernel
    (``csrc/vcycle.cuh``) applies the same rule.  On an H100 the B=512 x 512^2
    hierarchy (min_size 8) starts it at 64^2 in float32 and at 32^2 in
    float64."""
    cells = 0
    n_lv = len(shapes)
    for l in range(n_lv - 1, -1, -1):
        n = shapes[l][0] * shapes[l][1]
        cells += 5 * n
        if ((cells + n) * itemsize > RESIDENT_SMEM
                or n_lv - l > RESIDENT_LEVELS):
            return l + 1
    return 0


def cycle_launches(shapes, itemsize: int, l0: int = 0) -> int:
    """Kernel launches of one K2 cycle from level ``l0``: two tile passes for
    each level above the resident bottom, and one for the bottom (or, when
    not even the coarsest level fits, for the coarsest level's sweeps)."""
    lb = max(l0, cycle_resident_from(shapes, itemsize))
    return 2 * (min(lb, len(shapes) - 1) - l0) + 1


def smoothing_schedule(omega, nu):
    """Per-sweep damping factors for ``nu`` sweeps: a scalar repeats; a
    tuple of ``nu`` factors is applied in order pre-smoothing and reversed
    post-smoothing (the preconditioner stays SPD)."""
    if isinstance(omega, (tuple, list)):
        if len(omega) != nu:
            raise ValueError(f"omega schedule length {len(omega)} != nu={nu}")
        return tuple(float(w) for w in omega)
    return (float(omega),) * nu


def _nbsum(aw, an, x):
    """Neighbour sum of the symmetric stencil from the west/north planes."""
    xw = F.pad(x[..., :, :-1], (1, 0))
    xn = F.pad(x[..., :-1, :], (0, 0, 1, 0))
    east = F.pad((aw * x)[..., :, 1:], (0, 1))
    south = F.pad((an * x)[..., 1:, :], (0, 0, 0, 1))
    return aw * xw + east + an * xn + south


def _restrict(res, shape_c):
    """2x2 block sum (row pairs, then column pairs), zero-padded to the
    coarse level's shape."""
    t = res[..., 0::2, :] + res[..., 1::2, :]
    rc = t[..., :, 0::2] + t[..., :, 1::2]
    return F.pad(rc, (0, shape_c[1] - rc.shape[-1], 0, shape_c[0] - rc.shape[-2]))


def _prolong(e_c, shape):
    ny, nx = shape
    e = e_c[..., :ny // 2, :nx // 2]
    return e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _check_even(shapes):
    for sy, sx in shapes[:-1]:
        if sy % 2 or sx % 2:
            raise ValueError("the V-cycle needs even level dims (build the "
                             "hierarchy with pad_levels=True)")


def v_cycle_reference(levels: Sequence[StencilCoeffs], r: torch.Tensor, *,
                      omega=0.8, coarse_iters: int = 32, over: float = 1.8,
                      nu: int = 1, active=None) -> torch.Tensor:
    """Plain PyTorch V(nu, nu) cycle: ``(B, py, px) -> (B, py, px)``; images
    whose ``active`` flag is 0 come back as zeros."""
    shapes = [tuple(c.diag.shape[-2:]) for c in levels]
    _check_even(shapes)
    ws = smoothing_schedule(omega, nu)
    lvl = []
    for c in levels:
        wdi = {w: w * c.diag_inv for w in set(ws)}
        lvl.append((c.a_w, c.a_n, guarded_inverse(c.diag_inv), wdi))

    def smooth(l, x, b, w):
        aw, an, _dg, wdi = lvl[l]
        return (1.0 - w) * x + (b + _nbsum(aw, an, x)) * wdi[w]

    rs = [r]
    es = []
    for l in range(len(levels) - 1):
        aw, an, dg, wdi = lvl[l]
        e = wdi[ws[0]] * rs[l]
        for w in ws[1:]:
            e = smooth(l, e, rs[l], w)
        res = rs[l] - (dg * e - _nbsum(aw, an, e))
        es.append(e)
        rs.append(_restrict(res, shapes[l + 1]))

    lc = len(levels) - 1
    e = torch.zeros_like(rs[lc])
    for _ in range(coarse_iters):
        e = smooth(lc, e, rs[lc], ws[-1])

    for l in range(len(levels) - 2, -1, -1):
        e = es[l] + over * _prolong(e, shapes[l])
        for w in reversed(ws):
            e = smooth(l, e, rs[l], w)
    if active is not None:
        e = torch.where(active.ne(0).to(e.device)[:, None, None], e, 0.0)
    return e


# ---------------------------------------------------------------- CUDA path

_CTYPE = {torch.float32: "f32", torch.float64: "f64"}


def check_plane(t: torch.Tensor, name: str, shape, like: torch.Tensor):
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{like.dtype} on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class LevelArgs:
    """The hierarchy as the C entries take it: shape arrays and pointer
    arrays of the ``a_w``/``a_n``/``diag_inv`` planes.  Holds the ctypes
    buffers for as long as a launch may read them."""

    def __init__(self, levels: Sequence[StencilCoeffs], like: torch.Tensor):
        if like.dtype not in _CTYPE:
            raise ValueError(f"kernels take float32 or float64, not {like.dtype}")
        bsz = like.shape[0]
        shapes = [tuple(c.diag.shape[-2:]) for c in levels]
        _check_even(shapes)
        n = len(levels)
        self.n_levels = n
        self.shapes = shapes
        self.ny = (ctypes.c_int * n)(*(s[0] for s in shapes))
        self.nx = (ctypes.c_int * n)(*(s[1] for s in shapes))
        ptrs = {f: [] for f in ("a_w", "a_n", "diag_inv")}
        for l, (c, s) in enumerate(zip(levels, shapes)):
            for f in ptrs:
                plane = getattr(c, f)
                check_plane(plane, f"levels[{l}].{f}", (bsz,) + s, like)
                ptrs[f].append(plane.data_ptr())
        self.aw = (ctypes.c_void_p * n)(*ptrs["a_w"])
        self.an = (ctypes.c_void_p * n)(*ptrs["a_n"])
        self.dinv = (ctypes.c_void_p * n)(*ptrs["diag_inv"])
        self.suffix = _CTYPE[like.dtype]


def weights(omega, nu):
    ws = smoothing_schedule(omega, nu)
    return (ctypes.c_double * len(ws))(*ws)


def v_cycle(levels: List[StencilCoeffs], r: torch.Tensor, *, omega=0.8,
            coarse_iters: int = 32, over: float = 1.8, nu: int = 1,
            active=None, level_args=None) -> torch.Tensor:
    """One V(nu, nu) cycle ``z = M r`` on a ``(B, py, px)`` batch.

    ``levels`` is ``build_hierarchy(..., pad_levels=True)`` with planes
    ``(B, ny_l, nx_l)``.  ``active`` (optional, ``(B,)`` on ``r``'s device):
    an image whose flag is 0 does no work and comes back as zeros.  A CPU
    tensor runs the plain version; a CUDA tensor launches the CUDA kernel
    (float32 or float64, ``nu <= MAX_NU``): two shared-memory tile passes a
    level down to level :func:`cycle_resident_from` ``(shapes, itemsize)``,
    then one launch for the rest, each image's remaining pyramid resident in
    one CTA (:func:`cycle_launches` counts them).  The rule is by shape and
    dtype; a launch the card refuses raises.  ``level_args``: the
    :class:`LevelArgs` of ``levels``, kept by a caller that runs the cycle
    on one hierarchy again and again (else built for the call).
    """
    if r.device.type == "cpu":
        return v_cycle_reference(levels, r, omega=omega,
                                 coarse_iters=coarse_iters, over=over, nu=nu,
                                 active=active)
    if r.device.type != "cuda":
        raise ValueError(f"v_cycle: unsupported device {r.device}")
    if nu < 1 or nu > MAX_NU:
        raise ValueError(f"v_cycle: nu={nu} must be in 1..{MAX_NU}")
    from ._build import check, load_library

    lib = load_library()
    la = LevelArgs(levels, r) if level_args is None else level_args
    check_plane(r, "r", (r.shape[0],) + la.shapes[0], r)
    bsz = r.shape[0]
    flag = None
    if active is not None:
        if tuple(active.shape) != (bsz,) or active.device != r.device:
            raise ValueError(f"active: shape {tuple(active.shape)} on "
                             f"{active.device}, expected ({bsz},) on "
                             f"{r.device}")
        flag = active.ne(0).to(torch.int32)
    z = torch.empty_like(r) if flag is None else torch.zeros_like(r)
    per_image = lib.deff_cycle_scratch_elems(la.n_levels, la.ny, la.nx)
    scratch = torch.empty(bsz * per_image, dtype=r.dtype, device=r.device)
    ws = weights(omega, nu)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"deff_v_cycle_{la.suffix}")
        status = fn(bsz, la.n_levels, la.ny, la.nx, la.aw, la.an, la.dinv,
                    r.data_ptr(), z.data_ptr(), scratch.data_ptr(),
                    ws, nu, coarse_iters, float(over),
                    None if flag is None else flag.data_ptr(), stream)
    check(status, "v_cycle")
    v_cycle.launches += 1
    return z


v_cycle.launches = 0
