"""K1: up to ``k`` multigrid-preconditioned CG iterations per image with the
true-residual refresh in the tail — the CUDA kernel (``csrc/cgstep.cu``) and
its plain PyTorch version.

Replaces ``effectivediffusivityfvm_tpu/ops/kernels/cgstep_vmem.py``
(``cg_steps_pallas(refresh=True)``, body ``_kernel``).  The contract is the
same per image:

* ``active <= 0``: frozen — x/r/p/rz pass through, ``k_done = 0``,
  ``sum|r_true| = 0``, and no work is done;
* otherwise iterate while ``i < k and stop < sum|r| < hi`` (``sum|r|``
  starts at ``sum|r_in|``): ``q = A p``; ``alpha = rz/<p,q>`` (0 unless
  ``<p,q> > 0``); x/r update; ``z = M r`` (the K2 cycle); ``beta =
  <r,z>/rz`` (0 unless ``rz > 0``); ``p = z + beta p``;
* then, for every active image (also one that ran 0 iterations), the
  refresh: ``r = b - A x``, ``p = z = M r``, ``rz = <r, z>`` and
  ``sum|r_true| = sum|r|``.

``A`` is the level-0 symmetric stencil with the diagonal rebuilt as
``1/diag_inv``, exactly as inside the cycle.  Both versions update ``x``,
``r`` and ``p`` in place (saving three batch-sized planes per call) and
return them.

The window ends at the first iteration that starts with no live image, as
the JAX ``while_loop`` does: the plain version leaves its loop there, and
the kernel's host loop stops launching at most :data:`WINDOW_LAG`
iterations later (``csrc/window.cuh``: it reads a pinned flag the device
writes each iteration, waiting on an event, without draining the stream);
those iterations are gated and change nothing.  K5 and K7 end their windows
the same way.  ``cg_steps_reference.iterations`` counts the iterations the
plain version ran, ``deff_window_iter_count()`` those the kernels launched.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..fvm import StencilCoeffs, guarded_inverse
from .vcycle import (LevelArgs, check_plane, _nbsum, v_cycle_reference,
                     weights)

__all__ = ["cg_steps_reference", "cg_steps", "WINDOW_LAG"]

WINDOW_LAG = 1      # iterations with no live image a kernel window may launch


def batch_sum(v):
    """Per-image sum over the grid (every dim but the batch dim, so 2D and
    3D alike), accumulated in float64 and rounded to ``v``'s dtype once (as
    the kernels' reductions are)."""
    return torch.sum(v, dim=tuple(range(1, v.dim())),
                     dtype=torch.float64).to(v.dtype)


def cg_steps_reference(levels: Sequence[StencilCoeffs], x, r, p, rz, active,
                       stop, hi, k: int, *, omega=0.8, nu: int = 2,
                       coarse_iters: int = 32, over: float = 1.8):
    """Plain PyTorch version of :func:`cg_steps` (same arguments, same
    outputs, same in-place update of x/r/p)."""
    c0 = levels[0]
    dg0 = guarded_inverse(c0.diag_inv)
    dt = x.dtype

    def matvec(v):
        return dg0 * v - _nbsum(c0.a_w, c0.a_n, v)

    def cycle(v):
        return v_cycle_reference(levels, v, omega=omega,
                                 coarse_iters=coarse_iters, over=over, nu=nu)

    def where3(m, a, b):
        return torch.where(m[:, None, None], a, b)

    act = active > 0
    rz = rz.to(dt).clone()
    stop = stop.to(dt)
    hi = hi.to(dt)
    xs, rs, ps = x, r, p
    it = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    sr = batch_sum(torch.abs(r))
    live = act & (sr > stop) & (sr < hi) & (k > 0)
    for _ in range(k):
        if not bool(live.any()):
            break
        cg_steps_reference.iterations += 1
        q = matvec(p)
        pap = batch_sum(p * q)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        a3 = alpha[:, None, None]
        x = where3(live, x + a3 * p, x)
        r = where3(live, r - a3 * q, r)
        z = cycle(r)
        rz_new = batch_sum(r * z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = where3(live, z + beta[:, None, None] * p, p)
        rz = torch.where(live, rz_new, rz)
        it = it + live.to(torch.int32)
        sr = torch.where(live, batch_sum(torch.abs(r)), sr)
        live = live & (it < k) & (sr > stop) & (sr < hi)

    r_t = c0.b - matvec(x)
    z_t = cycle(r_t)
    xs.copy_(x)
    rs.copy_(where3(act, r_t, r))
    ps.copy_(where3(act, z_t, p))
    rz = torch.where(act, batch_sum(r_t * z_t), rz)
    sr_true = torch.where(act, batch_sum(torch.abs(r_t)), 0.0)
    k_done = torch.where(act, it, 0)
    return xs, rs, ps, rz, k_done, sr_true


def cg_steps(levels: List[StencilCoeffs], x, r, p, rz, active, stop, hi,
             k: int, *, omega=0.8, nu: int = 2, coarse_iters: int = 32,
             over: float = 1.8):
    """Run up to ``k`` fused MGCG iterations on a padded ``(B, py, px)``
    batch, then refresh and restart from the true residual.

    Args:
      levels: ``build_hierarchy(..., pad_levels=True)``, planes
        ``(B, ny_l, nx_l)``; ``levels[0].b`` is the right-hand side.
      x, r, p: CG state ``(B, py, px)``, updated in place.
      rz: ``<r, z>`` per image, ``(B,)``.
      active: ``> 0`` iterates, ``<= 0`` frozen, ``(B,)``.
      stop / hi: per-image early-exit and divergence thresholds on
        ``sum|r|``, ``(B,)``.
      k: iteration cap (host integer).
    Returns:
      ``(x, r, p, rz, k_done, sum_abs_r_true)``; ``k_done`` is int32
      ``(B,)``.

    A CPU tensor runs the plain version; a CUDA tensor launches the CUDA
    kernel (float32 or float64) or raises.
    """
    kw = dict(omega=omega, nu=nu, coarse_iters=coarse_iters, over=over)
    if x.device.type == "cpu":
        return cg_steps_reference(levels, x, r, p, rz, active, stop, hi, k,
                                  **kw)
    if x.device.type != "cuda":
        raise ValueError(f"cg_steps: unsupported device {x.device}")
    from ._build import check, load_library

    lib = load_library()
    la = LevelArgs(levels, x)
    bsz = x.shape[0]
    plane = (bsz,) + la.shapes[0]
    for name, t in (("x", x), ("r", r), ("p", p), ("b", levels[0].b)):
        check_plane(t, name, plane, x)
    rz = rz.to(x.dtype).contiguous().clone()
    active, stop, hi = (t.to(x.dtype).contiguous() for t in (active, stop, hi))
    for name, t in (("rz", rz), ("active", active), ("stop", stop),
                    ("hi", hi)):
        check_plane(t, name, (bsz,), x)
    k_done = torch.empty(bsz, dtype=torch.int32, device=x.device)
    sr_true = torch.empty(bsz, dtype=x.dtype, device=x.device)
    per_image = lib.deff_cg_scratch_elems(la.n_levels, la.ny, la.nx,
                                          x.element_size())
    scratch = torch.empty(bsz * per_image, dtype=x.dtype, device=x.device)
    iscratch = torch.empty(4 * bsz, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"deff_cg_steps_{la.suffix}")
        status = fn(bsz, la.n_levels, la.ny, la.nx, la.aw, la.an, la.dinv,
                    levels[0].b.data_ptr(), x.data_ptr(), r.data_ptr(),
                    p.data_ptr(), rz.data_ptr(), active.data_ptr(),
                    stop.data_ptr(), hi.data_ptr(), int(k),
                    k_done.data_ptr(), sr_true.data_ptr(),
                    weights(omega, nu), nu, coarse_iters, float(over),
                    scratch.data_ptr(), iscratch.data_ptr(), stream)
    check(status, "cg_steps")
    cg_steps.launches += 1
    return x, r, p, rz, k_done, sr_true


cg_steps.launches = 0
cg_steps_reference.iterations = 0
