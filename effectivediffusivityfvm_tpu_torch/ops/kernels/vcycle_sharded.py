"""K8: one shard's level of the row-sharded V-cycle -- the CUDA kernels
(``csrc/vcycle_sharded.cu`` over ``csrc/tiled.cuh``) and their plain
PyTorch versions.

Replaces ``effectivediffusivityfvm_tpu/parallel/fused2d.py``
(``_v_cycle_sharded_fused_impl``: ``_t1s_kernel``, ``_t2s_kernel``, and the
in-shard banded ``_banded_level``).  A shard holds rows ``[0, ny_l)`` of a
level; its neighbours' rows arrive as halo strips of ``HALO`` rows above
(north) and below (south), zeros at the global top and bottom:

* :func:`shard_t1`: on the window ``[north | shard | south]``, ``e = (w0
  dinv) r``, the damped-Jacobi sweeps at ``ws[1:]``, the residual ``r -
  (diag e - nbsum(e))`` and its 2x2 block sum; returns ``e`` and the coarse
  residual on the shard's rows;
* :func:`shard_t2`: ``e + over * e_c[i//2, j//2]`` on the window, the coarse
  correction ``e_c`` read through its own strips of ``HALO // 2`` coarse
  rows (every shard starts on an even global row, so fine window row ``i``
  takes coarse row ``i // 2``), then the sweeps in reverse; returns ``z``.

``nu`` sweeps and the residual invalidate ``nu + 1`` rows at the window's
edge, fewer than ``HALO``, so the shard's rows are exact.  The recursion
over levels, the strip exchanges and the coarse tail are the caller's
(``parallel/fused2d.py``).

On a CUDA tensor the wrappers launch the kernels (or raise); on a CPU
tensor they run the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from .vcycle import _CTYPE, check_plane, smoothing_schedule, weights
from .vcycle_tiled import HALO, post_reference, pre_reference

__all__ = ["HALO", "MAX_NU", "window", "shard_t1_reference",
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


def shard_t1(coef, r, rn, rs, *, omega, nu):
    """T1 of one shard (see the module docstring): ``(e, rc)``.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel."""
    _check_nu(nu, "shard_t1")
    if r.device.type == "cpu":
        return shard_t1_reference(coef, r, rn, rs, omega=omega, nu=nu)
    _device_of(r, "shard_t1")
    from ._build import check, load_library

    planes = tuple(coef) + (r, rn, rs)
    check_shard(planes, r, "shard_t1")
    lib = load_library()
    bsz, ny, nx = r.shape
    e = torch.empty_like(r)
    rc = torch.empty((bsz, ny // 2, nx // 2), dtype=r.dtype, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, f"deff_shard_t1_{_CTYPE[r.dtype]}")(
            bsz, ny, nx, HALO, pointers(planes), e.data_ptr(), rc.data_ptr(),
            weights(omega, nu), nu, stream), "shard_t1")
    shard_t1.launches += 1
    return e, rc


def shard_t2(coef, e, en, es, r, rn, rs, ec, ecn, ecs, *, omega, nu, over):
    """T2 of one shard (see the module docstring): ``z``.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel."""
    _check_nu(nu, "shard_t2")
    if r.device.type == "cpu":
        return shard_t2_reference(coef, e, en, es, r, rn, rs, ec, ecn, ecs,
                                  omega=omega, nu=nu, over=over)
    _device_of(r, "shard_t2")
    from ._build import check, load_library

    planes = tuple(coef) + (e, en, es, r, rn, rs)
    check_shard(planes, r, "shard_t2")
    check_coarse(ec, ecn, ecs, r, "shard_t2")
    lib = load_library()
    bsz, ny, nx = r.shape
    z = torch.empty_like(r)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(getattr(lib, f"deff_shard_t2_{_CTYPE[r.dtype]}")(
            bsz, ny, nx, HALO, pointers(planes + (ec, ecn, ecs)),
            z.data_ptr(), weights(omega, nu), nu, float(over), stream),
            "shard_t2")
    shard_t2.launches += 1
    return z


shard_t1.launches = 0
shard_t2.launches = 0
