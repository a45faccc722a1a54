"""Solve-result type and the check-cadence rules shared by the solvers
(torch port of the parts of ``effectivediffusivityfvm_tpu.solvers.driver``
that the MGCG solve uses)."""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SolveResult", "resolve_check_every", "resolve_first_window"]


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
