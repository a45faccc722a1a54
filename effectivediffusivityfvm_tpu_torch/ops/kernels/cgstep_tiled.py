"""K5: up to ``k`` multigrid-preconditioned CG iterations per image on the
banded engine's padded grid, each iteration three passes over level 0 --
the CUDA kernel (``csrc/cgstep_tiled.cu``: K1's three tile passes with the
banded engine's contract, over ``csrc/cgscalars.cuh``) and its plain
PyTorch version -- plus :func:`coeffs_from_d`, the matrix-free
rebuild of level 0 from the diffusivity field.

Replaces ``effectivediffusivityfvm_tpu/ops/kernels/cgstep_tiled.py``
(``cg_steps_tiled``: ``_pass_a``, ``_pass_b``, ``_pass_c``,
``_coeffs_from_dwin2``).  The contract per image:

* ``active <= 0``: frozen -- nothing is done and ``k_done = 0``;
* ``live = active > 0 and stop < sum|r_in| < hi``; while ``i < k`` and
  live: ``beta = rz/rz_prev`` (0 at ``i = 0`` or if ``rz_prev <= 0``),
  ``p = z + beta p`` (``z = p`` on entry), ``q = A p``, ``alpha =
  rz/<p,q>`` (0 unless ``<p,q> > 0``), ``x += alpha p``, ``r -= alpha q``,
  ``z`` = the banded cycle of ``r`` (T1, K2's cycle on ``levels[1:]``, T2),
  ``rz = <r, z>``, ``k_done += 1``, ``live = stop < sum|r| < hi``;
* no refresh: the caller refreshes between windows.

``A`` is the level-0 stencil with the diagonal rebuilt as ``1/diag_inv``.
Matrix-free (``d_field`` = the padded D, ``geom = (fx, fy, bcf, nxr)``):
level 0's ``a_w``/``a_n``/``diag_inv`` are rebuilt from D by
:func:`coeffs_from_d` (pads get ``diag_inv`` 0, not the stored identity);
x, r and p of every image are first multiplied by ``(D > 0)``, and ``z`` is
0 where ``D == 0``; levels 1+ stay stored.  Both versions update x, r and p
in place and return them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..fvm import StencilCoeffs, guarded_inverse
from .cgstep import batch_sum
from .vcycle import (LevelArgs, _CTYPE, _nbsum, check_plane,
                     smoothing_schedule, weights)
from .vcycle_tiled import (HALO, _check_levels, coarse_tail, post_reference,
                           pre_reference)

__all__ = ["coeffs_from_d", "cg_steps_tiled_reference", "cg_steps_tiled"]


def coeffs_from_d(d_pad: torch.Tensor, geom):
    """Level-0 ``(a_w, a_n, diag_inv)`` of the padded ``(..., py, px)`` D,
    term for term as the TPU kernel rebuilds them: face conductances by the
    guarded product form ``(2a) b / (a + b)`` times ``fx``/``fy`` (0 where
    ``a + b <= 0``), ``diag = a_w + a_e + a_n + a_s`` plus ``D * bcf`` at
    the real columns 0 and ``nxr - 1``, ``diag_inv = 1/diag`` where
    ``diag > 0``, else 0.  Assembly's reciprocal-form mean differs by 1-2
    ulp."""
    fx, fy, bcf, nxr = geom
    d = d_pad

    def hm(a, b):
        s = a + b
        pos = s > 0
        return torch.where(pos, (2.0 * a) * b / torch.where(pos, s, 1.0),
                           torch.zeros_like(s))

    hx = hm(d[..., :, :-1], d[..., :, 1:]) * fx
    hy = hm(d[..., :-1, :], d[..., 1:, :]) * fy
    aw = F.pad(hx, (1, 0))
    ae = F.pad(hx, (0, 1))
    an = F.pad(hy, (0, 0, 1, 0))
    as_ = F.pad(hy, (0, 0, 0, 1))
    diag = aw + ae + an + as_
    col = torch.arange(d.shape[-1], device=d.device)
    edge = (col == 0) | (col == nxr - 1)
    diag = diag + torch.where(edge, d * bcf, torch.zeros_like(d))
    return aw, an, guarded_inverse(diag)


def _tiled_args(levels, x, d_field, geom):
    _check_levels(levels, x)
    if d_field is not None and geom is None:
        raise ValueError("cg_steps_tiled: d_field requires geom")


def cg_steps_tiled_reference(levels: Sequence[StencilCoeffs], x, r, p, rz,
                             active, stop, hi, k: int, *, omega=0.8,
                             nu: int = 2, coarse_iters: int = 32,
                             over: float = 1.8, d_field=None, geom=None):
    """Plain PyTorch version of :func:`cg_steps_tiled` (same arguments, same
    outputs, same in-place update of x/r/p)."""
    _tiled_args(levels, x, d_field, geom)
    ws = smoothing_schedule(omega, nu)
    mg = dict(omega=omega, nu=nu, coarse_iters=coarse_iters, over=over)
    c0 = levels[0]
    dt = x.dtype
    if d_field is not None:
        d = d_field.to(dt)
        coef = coeffs_from_d(d, geom)
        ind = (d > 0).to(dt)
        x.mul_(ind)
        r.mul_(ind)
        p.mul_(ind)
    else:
        coef = (c0.a_w, c0.a_n, c0.diag_inv)
    aw, an, di = coef
    dg = guarded_inverse(di)

    def where3(m, a, b):
        return torch.where(m[:, None, None], a, b)

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
        cg_steps_tiled_reference.iterations += 1
        beta = torch.where(live & (rz_p > 0) & (i > 0),
                           rz_c / torch.where(rz_p > 0, rz_p, 1.0), 0.0)
        p = where3(live, z + beta[:, None, None] * p, p)
        q = dg * p - _nbsum(aw, an, p)
        pap = batch_sum(p * q)
        alpha = torch.where(live & (pap > 0),
                            rz_c / torch.where(pap > 0, pap, 1.0), 0.0)
        a3 = alpha[:, None, None]
        x = where3(live, x + a3 * p, x)
        r = where3(live, r - a3 * q, r)
        sr_out = batch_sum(torch.abs(r))
        e, rc = pre_reference(coef, r, ws)
        ec = coarse_tail(levels, rc, plain=True, **mg)
        z_new = post_reference(coef, e, r, ec, ws, over)
        if d_field is not None:
            z_new = torch.where(d > 0, z_new, torch.zeros_like(z_new))
        rz_out = batch_sum(r * z_new)
        sr = torch.where(live, sr_out, sr)
        rz_p = torch.where(live, rz_c, rz_p)
        rz_c = torch.where(live, rz_out, rz_c)
        z = where3(live, z_new, z)
        k_done = k_done + live.to(torch.int32)
        live = live & (sr > stop) & (sr < hi)
    xs.copy_(x)
    rs.copy_(r)
    ps.copy_(p)
    return xs, rs, ps, rz_c, k_done


def cg_steps_tiled(levels: List[StencilCoeffs], x, r, p, rz, active, stop,
                   hi, k: int, *, omega=0.8, nu: int = 2,
                   coarse_iters: int = 32, over: float = 1.8, d_field=None,
                   geom=None):
    """Run up to ``k`` banded MGCG iterations on a padded ``(B, py, px)``
    batch.

    Args:
      levels: ``build_hierarchy(..., pad_levels=True)`` of an operator
        padded to ``tiled_pad_shape``, planes ``(B, ny_l, nx_l)``.
      x, r, p: CG state ``(B, py, px)``, updated in place.
      rz: ``<r, z>`` per image, ``(B,)``.
      active: ``> 0`` iterates, ``<= 0`` frozen, ``(B,)``.
      stop / hi: per-image early-exit and divergence thresholds on
        ``sum|r|``, ``(B,)``.
      k: iteration cap (host integer).
      d_field, geom: matrix-free level 0 (see the module docstring).
    Returns:
      ``(x, r, p, rz, k_done)``; ``k_done`` is int32 ``(B,)``.

    A CPU tensor runs the plain version; a CUDA tensor launches the CUDA
    kernel (float32 or float64, ``nu <= HALO - 2``) or raises.
    """
    if nu < 1 or nu > HALO - 2:
        raise ValueError(f"cg_steps_tiled: nu={nu} must be in 1..{HALO - 2}")
    kw = dict(omega=omega, nu=nu, coarse_iters=coarse_iters, over=over,
              d_field=d_field, geom=geom)
    if x.device.type == "cpu":
        return cg_steps_tiled_reference(levels, x, r, p, rz, active, stop, hi,
                                        k, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"cg_steps_tiled: unsupported device {x.device}")
    from ._build import check, load_library

    _tiled_args(levels, x, d_field, geom)
    lib = load_library()
    la = LevelArgs(levels, x)
    bsz = x.shape[0]
    plane = (bsz,) + la.shapes[0]
    for name, t in (("x", x), ("r", r), ("p", p)):
        check_plane(t, name, plane, x)
    if d_field is not None:
        check_plane(d_field, "d_field", plane, x)
        fx, fy, bcf, nxr = (float(geom[0]), float(geom[1]), float(geom[2]),
                            int(geom[3]))
        d_ptr = d_field.data_ptr()
    else:
        fx = fy = bcf = 0.0
        nxr, d_ptr = 0, None
    rz = rz.to(x.dtype).contiguous().clone()
    active, stop, hi = (t.to(x.dtype).contiguous() for t in (active, stop, hi))
    for name, t in (("rz", rz), ("active", active), ("stop", stop),
                    ("hi", hi)):
        check_plane(t, name, (bsz,), x)
    k_done = torch.empty(bsz, dtype=torch.int32, device=x.device)
    per_image = lib.deff_cg_tiled_scratch_elems(la.n_levels, la.ny, la.nx,
                                                x.element_size())
    scratch = torch.empty(bsz * per_image, dtype=x.dtype, device=x.device)
    iscratch = torch.empty(2 * bsz, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"deff_cg_steps_tiled_{la.suffix}")
        status = fn(bsz, la.n_levels, la.ny, la.nx, la.aw, la.an, la.dinv,
                    d_ptr, fx, fy, bcf, nxr, x.data_ptr(), r.data_ptr(),
                    p.data_ptr(), rz.data_ptr(), active.data_ptr(),
                    stop.data_ptr(), hi.data_ptr(), int(k),
                    k_done.data_ptr(), weights(omega, nu), nu, coarse_iters,
                    float(over), scratch.data_ptr(), iscratch.data_ptr(),
                    stream)
    check(status, "cg_steps_tiled")
    cg_steps_tiled.launches += 1
    return x, r, p, rz, k_done


cg_steps_tiled.launches = 0
cg_steps_tiled_reference.iterations = 0
