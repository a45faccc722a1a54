"""Generic preconditioned-CG engine shared by the Krylov solvers (torch port
of ``effectivediffusivityfvm_tpu.solvers.pcg``).

Parameterized over the matvec, the preconditioner, the Deff monitor and the
grid rank, so one loop serves 2D and 3D diagonal-PCG (``cg``), the refined
inner solves (``cgir``) and deflated multigrid-PCG (``dmg``).  The hooks
``reduce_any_fn``, ``mean_abs_fn`` and ``dot_fn`` are there for the sharded
modes, whose monitors reduce over a mesh.

Semantics are the JAX engine's: windows of 1, then ``check_every``
iterations, the last cut at ``max_iter``; a check follows a window whose
last iteration index ``it`` has ``(it - 1) % check_every == 0`` (a cut last
window does not check).  At a check the true residual is recomputed and the
recurrence restarted on it; ``criterion="residual"`` stops on ``mean|r| <
tol``, ``"relresidual"`` divides by ``mean|b|``, ``"deff"`` applies the
reference's percent-change rule (Deff2D.cuh:1265).  A best-residual
snapshot and a divergence net (non-finite or 1e3x the best residual) stop
an image and return its best iterate.  Batched mode freezes converged
images: their ``alpha``, ``beta`` and ``<r, z>`` are gated by ``active``.

The loop runs on the host, one window at a time; the one device-to-host
read a window is the "any image still active" flag.  Dots and means are
taken in the array's dtype, as the JAX engine takes them.

``precond(r, active)`` gets the ``(B,)`` active flags in batched mode (None
in single mode and for the opening residual): a preconditioner may skip the
frozen images' work, whose result the loop never uses.
"""

from __future__ import annotations

from typing import Callable

import torch

from .driver import SolveResult

__all__ = ["run_pcg"]


def run_pcg(
    matvec: Callable,
    precond: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    deff_fn: Callable,
    *,
    tol: float,
    max_iter: int,
    check_every: int,
    criterion: str,
    grid_ndim: int,
    batched: bool,
    reduce_any_fn=None,
    mean_abs_fn=None,
    dot_fn=None,
) -> SolveResult:
    dtype, dev = x0.dtype, x0.device
    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    axes = tuple(range(-grid_ndim, 0))
    reduce_any_fn = reduce_any_fn or torch.any
    bshape = x0.shape[:-grid_ndim]

    def dot(u, v):
        return dot_fn(u, v) if dot_fn else torch.sum(u * v, dim=axes)

    def mean_abs(u):
        return (mean_abs_fn(u) if mean_abs_fn
                else torch.mean(torch.abs(u), dim=axes))

    def expand(v):
        return v.reshape(v.shape + (1,) * grid_ndim) if batched else v

    def gate(active, new, old):
        return torch.where(active, new, old) if batched else new

    bscale = mean_abs(b) if criterion == "relresidual" else None

    def fresh(x, active=None):
        r = b - matvec(x)
        z = precond(r, active)
        return r, z, dot(r, z)

    def cg_iter(x, r, p, rz, active):
        ap = matvec(p)
        pap = dot(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        if batched:
            alpha = torch.where(active, alpha, 0.0)
        x = x + expand(alpha) * p
        r = r - expand(alpha) * ap
        z = precond(r, active)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        if batched:
            beta = torch.where(active, beta, 0.0)
            rz_new = torch.where(active, rz_new, rz)
        p = z + expand(beta) * p
        return x, r, p, rz_new

    def scal(v):
        return torch.full(bshape, v, dtype=dtype, device=dev)

    x = x0
    r, p, rz = fresh(x0)
    deff, deff_old, pc, conv = scal(1.0), scal(5.0), scal(100.0), scal(100.0)
    iters = torch.zeros(bshape, dtype=torch.int32, device=dev)
    x_best = x0
    best = mean_abs(r)
    bad = torch.zeros(bshape, dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter:
        alive = tol_ < torch.abs(pc)
        if not bool(reduce_any_fn(alive)):
            break
        active = alive if batched else None
        k = 1 if it == 0 else min(check_every, max_iter - it)
        for _ in range(k):
            x, r, p, rz = cg_iter(x, r, p, rz, active)
        it += k
        if batched:
            iters = iters + torch.where(active, k, 0).to(torch.int32)
        if (it - 1) % check_every:
            continue        # a window cut by max_iter ends without a check

        # restart the recurrence on the true residual
        r_true, z_true, rz_true = fresh(x, active)
        if batched:
            r = torch.where(expand(active), r_true, r)
            p = torch.where(expand(active), z_true, p)
            rz = torch.where(active, rz_true, rz)
        else:
            r, p, rz = r_true, z_true, rz_true

        # stagnation/divergence net: keep the best-true-residual iterate; a
        # non-finite residual or one far above the best stops the image
        r_mean = mean_abs(r_true)
        improved = r_mean < best
        if batched:
            improved = improved & active
        x_best = torch.where(expand(improved), x, x_best)
        best = torch.where(improved, r_mean, best)
        diverged = ~torch.isfinite(r_mean) | (r_mean > 1e3 * best)
        if batched:
            diverged = diverged & active

        deff_new = deff_fn(x)
        if criterion == "deff":
            pc_new = (deff_old - deff_new) / deff_old
            deff_old = gate(active, deff_new, deff_old)
        elif criterion == "relresidual":
            pc_new = r_mean / bscale
        else:
            pc_new = r_mean
        deff = gate(active, deff_new, deff)
        pc = gate(active, pc_new, pc)
        pc = torch.where(diverged, 0.0, pc)       # forces the stop
        conv = gate(active, pc_new, conv)
        bad = bad | diverged
    if not batched:
        iters = torch.tensor(it, dtype=torch.int32, device=dev)

    # healthy images return their last iterate; those whose divergence net
    # fired return the best one, with conv reporting its residual
    x_out = torch.where(expand(bad), x_best, x)
    deff_out = deff_fn(x_out)
    if criterion == "relresidual":
        conv = torch.where(bad, best / bscale, conv)
    elif criterion != "deff":
        conv = torch.where(bad, best, conv)
    return SolveResult(x=x_out, deff=deff_out, conv=conv, iters=iters)
