"""K4: the banded V-cycle for fine grids past the whole-cycle engine's size
-- the CUDA kernel (``csrc/vcycle_tiled.cu``: K2's level passes of
``csrc/levelpass2d.cuh`` in the banded sweep form as T1 and T2, around K2's
cycle from level 1, all from one entry) and its plain PyTorch version --
and the padded shape the banded engine solves on.

Replaces ``effectivediffusivityfvm_tpu/ops/kernels/vcycle_tiled.py``
(``v_cycle_tiled``: ``_pre_kernel``, ``_post_kernel``, ``coarse_tail``).
One cycle ``z = M r`` is three steps, as there:

* T1 on level 0: ``e = (w0 dinv) r``, damped-Jacobi sweeps at ``ws[1:]``
  in the form ``(1 - w) e + (w (r + nbsum(e))) dinv``, the residual
  ``r - (diag e - nbsum(e))`` with ``diag = 1/dinv`` (0 where dinv is 0),
  and its 2x2 block sum (row pairs, then column pairs);
* the coarse tail: the K2 cycle (:func:`~.vcycle.v_cycle`) on ``levels[1:]``;
* T2 on level 0: ``e + over * e_c[i/2, j/2]``, then the sweeps in reverse.

The level-0 sweep is rounded as the TPU engine's ``_smooth_w`` rounds it,
which differs from K2's ``(rhs + nbsum) (w dinv)``, so the plain version of
the cycle is written out here rather than taken from K2's.

:func:`tiled_band` and :func:`tiled_pad_shape` are the JAX package's,
copied exactly.  On the card the band itself sets nothing -- the kernels
tile as suits the card -- but the padded shape (rows to a band multiple,
columns to the lane quantum of 256) fixes the multigrid hierarchy and with
it the iteration counts, so both stay as they are, lane quantum included.

On a CUDA tensor :func:`v_cycle_tiled` launches the kernels (or raises);
on a CPU tensor it runs :func:`v_cycle_tiled_reference`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..fvm import guarded_inverse
from .vcycle import (LevelArgs, _nbsum, check_plane, smoothing_schedule,
                     v_cycle, v_cycle_reference, weights)

__all__ = ["HALO", "tiled_band", "tiled_pad_shape", "fits_whole_cycle",
           "coarse_tail", "pre_reference", "post_reference",
           "v_cycle_tiled_reference", "v_cycle_tiled"]

HALO = 8          # the TPU engine's halo rows (nu <= HALO in the cycle)
_LANES = 256      # fine nx padded to this (nx/2 stays lane-aligned)


def tiled_band(ny: int, nx: int, itemsize: int = 4) -> int:
    """Largest power-of-two band height whose T1/T2 working set (~22 window
    planes incl. Mosaic double-buffering) stays under the VMEM budget,
    capped so a small grid is one band instead of mostly padding."""
    budget = 100 * 1024 * 1024
    cap = -(-ny // HALO) * HALO      # HALO-multiple: the banded CG engine's
    for band in (512, 256, 128, 64, 32, 16, 8):   # in-array halo specs
        if 22 * (band + 2 * HALO) * nx * itemsize < budget:   # index in
            return min(band, cap) if band >= cap else band    # HALO units
    return 8


def tiled_pad_shape(ny: int, nx: int, band: int) -> tuple:
    """Fine-level padded shape: rows to a band multiple, cols to the lane
    quantum (so every coarser level stays even/aligned with no re-padding
    for the typical power-of-two depth)."""
    py = -(-ny // band) * band
    px = -(-nx // _LANES) * _LANES
    return py, px


def fits_whole_cycle(ny: int, nx: int, itemsize: int = 4) -> bool:
    """True below the size at which the JAX package moves a solve from its
    whole-cycle engine to the banded one: 16 fine planes under 100 MiB (its
    ``vcycle_fits_vmem``, the VMEM budget of the TPU kernel).  Nothing on
    the card depends on it; it keeps the port on the JAX package's
    algorithm, and so on its iteration counts, at every size."""
    return 16 * ny * nx * itemsize < 100 * 1024 * 1024


def _smooth_w(aw, an, di, x, b, w):
    return (1.0 - w) * x + w * (b + _nbsum(aw, an, x)) * di


def pre_reference(coef, r, ws):
    """Plain T1: ``(e, rc)`` for level-0 windows ``coef = (aw, an, dinv)``,
    ``r`` ``(B, py, px)``; ``rc`` is ``(B, py/2, px/2)``."""
    aw, an, di = coef
    e = ws[0] * di * r
    for w in ws[1:]:
        e = _smooth_w(aw, an, di, e, r, w)
    res = r - (guarded_inverse(di) * e - _nbsum(aw, an, e))
    t = res[..., 0::2, :] + res[..., 1::2, :]
    return e, t[..., 0::2] + t[..., 1::2]


def post_reference(coef, e, r, ec, ws, over):
    """Plain T2: ``z`` from the pre-smoothed ``e``, ``r`` and the coarse
    correction ``ec`` ``(B, py/2, px/2)``."""
    aw, an, di = coef
    ecw = ec.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    e = e + over * ecw
    for w in reversed(ws):
        e = _smooth_w(aw, an, di, e, r, w)
    return e


def _check_levels(levels, r):
    if len(levels) < 2:
        raise ValueError("the banded cycle needs at least two levels")
    py, px = r.shape[-2:]
    if py % 2 or px % 2 or tuple(levels[1].diag.shape[-2:]) != (py // 2,
                                                                px // 2):
        raise ValueError(f"the banded cycle needs even level-0 dims and "
                         f"levels[1] of shape ({py // 2}, {px // 2}), got "
                         f"{(py, px)} and {tuple(levels[1].diag.shape[-2:])}"
                         " (build the hierarchy on tiled_pad_shape)")


def coarse_tail(levels, rc, *, omega, nu, coarse_iters, over, plain=False):
    """The coarse correction of the restricted residual ``rc``: K2's cycle
    on ``levels[1:]`` (its plain version if ``plain``), with ``rc`` zero-
    padded to ``levels[1]``'s shape."""
    py1, px1 = levels[1].diag.shape[-2:]
    rc = F.pad(rc, (0, px1 - rc.shape[-1], 0, py1 - rc.shape[-2]))
    cycle = v_cycle_reference if plain else v_cycle
    return cycle(levels[1:], rc, omega=omega, coarse_iters=coarse_iters,
                 over=over, nu=nu)


def v_cycle_tiled_reference(levels, r, *, omega=0.8, nu: int = 1,
                            coarse_iters: int = 32,
                            over: float = 1.8) -> torch.Tensor:
    """Plain PyTorch banded V(nu, nu) cycle: ``(B, py, px) -> (B, py, px)``."""
    _check_levels(levels, r)
    ws = smoothing_schedule(omega, nu)
    c0 = levels[0]
    coef = (c0.a_w, c0.a_n, c0.diag_inv)
    e, rc = pre_reference(coef, r, ws)
    ec = coarse_tail(levels, rc, omega=omega, nu=nu,
                     coarse_iters=coarse_iters, over=over, plain=True)
    return post_reference(coef, e, r, ec, ws, over)


def v_cycle_tiled(levels, r, *, omega=0.8, nu: int = 1,
                  coarse_iters: int = 32, over: float = 1.8,
                  level_args=None) -> torch.Tensor:
    """One banded V(nu, nu) cycle ``z = M r`` on a ``(B, py, px)`` batch.

    ``levels`` is ``build_hierarchy(..., pad_levels=True)`` of an operator
    padded to :func:`tiled_pad_shape`; ``nu <= HALO``.  A CPU tensor runs
    the plain version; a CUDA tensor launches T1 and T2 (float32 or
    float64) around K2's cycle on ``levels[1:]``, from one C entry.
    ``level_args``: the :class:`~.vcycle.LevelArgs` of ``levels``, kept by a
    caller that runs the cycle on one hierarchy again and again (else built
    for the call).
    """
    if nu < 1 or nu > HALO:
        raise ValueError(f"v_cycle_tiled: nu={nu} must be in 1..{HALO}")
    if r.device.type == "cpu":
        return v_cycle_tiled_reference(levels, r, omega=omega, nu=nu,
                                       coarse_iters=coarse_iters, over=over)
    if r.device.type != "cuda":
        raise ValueError(f"v_cycle_tiled: unsupported device {r.device}")
    from ._build import check, load_library

    _check_levels(levels, r)
    lib = load_library()
    la = LevelArgs(levels, r) if level_args is None else level_args
    bsz = r.shape[0]
    check_plane(r, "r", (bsz,) + la.shapes[0], r)
    z = torch.empty_like(r)
    per_image = lib.deff_cycle_tiled_scratch_elems(la.n_levels, la.ny, la.nx)
    scratch = torch.empty(bsz * per_image, dtype=r.dtype, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, f"deff_v_cycle_tiled_{la.suffix}")(
            bsz, la.n_levels, la.ny, la.nx, la.aw, la.an, la.dinv,
            r.data_ptr(), z.data_ptr(), scratch.data_ptr(),
            weights(omega, nu), nu, coarse_iters, float(over), stream),
            "v_cycle_tiled")
    v_cycle_tiled.launches += 1
    return z


v_cycle_tiled.launches = 0
