"""Solve-result type, the check-cadence rules and the sweep-solver loops
(torch port of ``effectivediffusivityfvm_tpu.solvers.driver``).

Every sweep-based solver shares the same outer control flow, which
reproduces the reference drivers JacobiGPU/JacobiGPUPreCond
(Deff2D.cuh:1163-1314 / 1024-1160):

  * sweeps indexed 0,1,2,...; a convergence check runs on every sweep whose
    index is a multiple of ``check_every`` (``iterCount % iterToCheck == 0``,
    Deff2D.cuh:1243 — i.e. after sweeps 1, N+1, 2N+1, ... have run);
  * ``deff_old=5``, ``deff=1``, ``percent_change=100`` initial values
    (Deff2D.cuh:1171-1173);
  * ``percent_change = (deff_old - deff_new)/deff_old`` (Deff2D.cuh:1265);
  * loop while ``iter < max_iter and tol < |percent_change|``
    (Deff2D.cuh:1232); ``conv`` = last computed value (Deff2D.cuh:1275).

The loop runs on the host, one check-aligned window of sweeps at a time:
the solver's ``sweeps(x, k, ...)`` issues the window's ``k`` sweeps
without a host sync, and the host reads the "still active" flag back once
per window.

``criterion="residual"`` swaps the monitor for the mean absolute flux
imbalance; ``criterion="relresidual"`` divides it by ``mean(|b|)``.

The batched loop advances a ``(B, ny, nx)`` stack with per-image freezing:
once an image meets the criterion its field stops updating, so its final
state matches a solo run at the same sweep schedule exactly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops import fvm
from ..ops.flux import BoundaryFluxSpec, boundary_deff

__all__ = ["SolveResult", "run_single", "run_batched", "resolve_check_every",
           "resolve_first_window"]

CRITERIA = ("deff", "residual", "relresidual")


def resolve_first_window(first_window: int, check_every: int, criterion: str,
                         matrix_free: bool = False) -> int:
    """Length of the fused-MGCG opening window.

    ``0`` = auto: ``check_every`` under the residual criteria (the in-kernel
    early exit makes a full first window free for converged images), 1 for
    ``criterion="deff"`` (no in-kernel stop) and for a matrix-free level 0.
    Explicit positive values are honoured as they are.
    """
    if first_window != 0:
        return first_window
    if matrix_free or criterion not in ("residual", "relresidual"):
        return 1
    return check_every


def resolve_check_every(check_every: int, default: int) -> int:
    """``check_every <= 0`` (or None) means the solver's default; a positive
    value is honoured exactly."""
    return default if check_every is None or check_every <= 0 else check_every


class SolveResult(NamedTuple):
    x: torch.Tensor      # final concentration field(s)
    deff: torch.Tensor   # Deff at the last convergence check
    conv: torch.Tensor   # last percent-change (or residual) observed
    iters: torch.Tensor  # iterations executed (per image when batched)


def _check_criterion(criterion: str) -> None:
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion {criterion!r}")


def _window(it: int, end: int, check_every: int) -> int:
    """Sweeps to the next global check (1 at ``it == 0``, ``check_every``
    on every later check boundary), cut by the budget ``end``."""
    return min(check_every - ((it - 1) % check_every), end - it)


def _monitor(criterion, x, deff_old, bscale, deff_fn, resid_fn):
    """``(deff_new, pc_new)`` of the field ``x``."""
    deff_new = deff_fn(x)
    if criterion == "deff":
        pc_new = (deff_old - deff_new) / deff_old
    elif criterion == "relresidual":
        pc_new = resid_fn(x) / bscale
    else:
        pc_new = resid_fn(x)
    return deff_new, pc_new


def _monitor_fns(coeffs, spec, deff_fn, resid_fn):
    """The Deff and residual monitors: the 2D ones unless given."""
    return (deff_fn or (lambda x: boundary_deff(spec, x)),
            resid_fn or (lambda x: fvm.residual(coeffs, x)))


def run_single(
    sweeps: Callable[[torch.Tensor, int], torch.Tensor],
    coeffs: fvm.StencilCoeffs,
    spec: BoundaryFluxSpec,
    x0: torch.Tensor,
    *,
    tol: float,
    max_iter: int,
    check_every: int,
    criterion: str,
    it0: int = 0,
    deff0: float = 1.0,
    deff_old0: float = 5.0,
    deff_fn=None,
    resid_fn=None,
) -> SolveResult:
    """Solve one ``(ny, nx)`` image; ``sweeps(x, k)`` runs ``k`` sweeps.

    Protocol carry (segmented solves): ``it0`` is the GLOBAL sweep count
    already executed before this call; checks stay on the global schedule
    (sweeps 1, 1+N, 1+2N, ...), and ``deff0``/``deff_old0`` carry the monitor
    state of the previous segment, so a run split into segments stops at
    exactly the sweep where one continuous reference-protocol run would.
    Valid when each segment ends on a check boundary; ``max_iter`` is this
    call's sweep budget.  ``deff_fn``/``resid_fn`` replace the monitors
    (the 3D solvers pass the voxel ones).
    """
    _check_criterion(criterion)
    deff_fn, resid_fn = _monitor_fns(coeffs, spec, deff_fn, resid_fn)
    dtype, dev = x0.dtype, x0.device
    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    bscale = (torch.mean(torch.abs(coeffs.b)) if criterion == "relresidual"
              else None)
    end = it0 + max_iter
    x = x0
    it = it0
    deff = torch.tensor(deff0, dtype=dtype, device=dev)
    deff_old = torch.tensor(deff_old0, dtype=dtype, device=dev)
    pc = torch.tensor(100.0, dtype=dtype, device=dev)
    conv = pc
    while it < end and bool(tol_ < torch.abs(pc)):
        k = _window(it, end, check_every)
        x = sweeps(x, k)
        it += k
        if (it - 1) % check_every == 0:
            deff, pc = _monitor(criterion, x, deff_old, bscale, deff_fn,
                                resid_fn)
            if criterion == "deff":
                deff_old = deff
            conv = pc
    return SolveResult(x=x, deff=deff, conv=conv,
                       iters=torch.tensor(it - it0, dtype=torch.int32,
                                          device=dev))


def run_batched(
    sweeps: Callable[[torch.Tensor, int, torch.Tensor], torch.Tensor],
    coeffs: fvm.StencilCoeffs,
    spec: BoundaryFluxSpec,
    x0: torch.Tensor,
    *,
    tol: float,
    max_iter: int,
    check_every: int,
    criterion: str,
    it0: int = 0,
    deff0=1.0,
    deff_old0=5.0,
    deff_fn=None,
    resid_fn=None,
) -> SolveResult:
    """Solve a ``(B, ny, nx)`` batch with per-image freezing;
    ``sweeps(x, k, active)`` runs ``k`` sweeps and leaves the images whose
    ``active`` flag is False unchanged.  ``it0``/``deff0``/``deff_old0`` are
    the segmented-solve carry of :func:`run_single` (``deff0``/``deff_old0``
    may be ``(B,)`` tensors), ``deff_fn``/``resid_fn`` as there."""
    _check_criterion(criterion)
    deff_fn, resid_fn = _monitor_fns(coeffs, spec, deff_fn, resid_fn)
    dtype, dev = x0.dtype, x0.device
    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    bsz = x0.shape[0]
    grid_axes = tuple(range(1, x0.dim()))
    bscale = (torch.mean(torch.abs(coeffs.b), dim=grid_axes)
              if criterion == "relresidual" else None)
    end = it0 + max_iter

    def full(v):
        return torch.as_tensor(v, dtype=dtype, device=dev).expand(bsz).clone()

    x = x0
    it = it0
    deff, deff_old = full(deff0), full(deff_old0)
    pc, conv = full(100.0), full(100.0)
    iters = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    while it < end:
        active = tol_ < torch.abs(pc)
        if not bool(active.any()):
            break
        k = _window(it, end, check_every)
        x = sweeps(x, k, active)
        it += k
        iters += active.to(torch.int32) * k
        if (it - 1) % check_every == 0:
            deff_new, pc_new = _monitor(criterion, x, deff_old, bscale,
                                        deff_fn, resid_fn)
            deff = torch.where(active, deff_new, deff)
            if criterion == "deff":
                deff_old = torch.where(active, deff_new, deff_old)
            pc = torch.where(active, pc_new, pc)
            conv = torch.where(active, pc_new, conv)
    return SolveResult(x=x, deff=deff, conv=conv, iters=iters)
