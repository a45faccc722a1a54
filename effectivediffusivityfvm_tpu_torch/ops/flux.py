"""Boundary-flux effective-diffusivity reduction (torch port of
``effectivediffusivityfvm_tpu.ops.flux``).

Math (documentation PDF eq. 6):
  MFL[i] = D[i, 0]  * (x[i, 0]  - CL) / (dx/2)      left-boundary flux per row
  MFR[i] = D[i, -1] * (CR - x[i, -1]) / (dx/2)      right-boundary flux per row
  Deff   = (sum(MFL) + sum(MFR)) / (2 * ny) / (CR - CL)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BoundaryFluxSpec", "make_flux_spec", "deff_from_columns",
           "boundary_deff", "deff_flux_average"]


class BoundaryFluxSpec(NamedTuple):
    """Per-solve data for Deff.  ``d_left``/``d_right`` are ``(..., ny)``;
    the other fields have the batch shape ``(...)``."""

    d_left: torch.Tensor
    d_right: torch.Tensor
    c_left: torch.Tensor
    c_right: torch.Tensor
    inv_half_dx: torch.Tensor   # 1 / (dx/2) = 2 * nx


def make_flux_spec(d_field: torch.Tensor, c_left, c_right) -> BoundaryFluxSpec:
    """Spec for a ``(..., ny, nx)`` diffusivity field."""
    nx = d_field.shape[-1]
    batch = d_field.shape[:-2]

    def full(v):
        return torch.full(batch, v, dtype=d_field.dtype, device=d_field.device)

    return BoundaryFluxSpec(
        d_left=d_field[..., :, 0],
        d_right=d_field[..., :, -1],
        c_left=full(c_left),
        c_right=full(c_right),
        inv_half_dx=full(2.0 * nx),
    )


def deff_from_columns(spec: BoundaryFluxSpec, x_left: torch.Tensor,
                      x_right: torch.Tensor) -> torch.Tensor:
    """Deff from the two boundary columns ``(..., ny)``.  The row sums
    accumulate in float32 or wider, whatever the field dtype."""
    ny = x_left.shape[-1]
    acc = torch.promote_types(x_left.dtype, torch.float32)
    cl = spec.c_left[..., None]
    cr = spec.c_right[..., None]
    ihdx = spec.inv_half_dx[..., None]
    mfl = (spec.d_left * (x_left - cl) * ihdx).to(acc)
    mfr = (spec.d_right * (cr - x_right) * ihdx).to(acc)
    q_avg = (torch.sum(mfl, dim=-1) + torch.sum(mfr, dim=-1)) / (2.0 * ny)
    denom = (spec.c_right - spec.c_left).to(acc)
    return (q_avg / denom).to(x_left.dtype)


def boundary_deff(spec: BoundaryFluxSpec, x: torch.Tensor) -> torch.Tensor:
    """Deff of a ``(..., ny, nx)`` concentration field."""
    return deff_from_columns(spec, x[..., :, 0], x[..., :, -1])


def deff_flux_average(d_field: torch.Tensor, x: torch.Tensor, c_left,
                      c_right) -> torch.Tensor:
    """Deff from the flux averaged over EVERY vertical cut.

    At steady state the net flux through every x-cut is the same;
    :func:`boundary_deff` samples only the two boundary cuts, where the
    half-cell Dirichlet gradients amplify solution noise by ``2 nx``.
    Averaging the ``nx - 1`` interior face fluxes and the two boundary
    fluxes suppresses that noise by ~sqrt(nx).  Equal to
    :func:`boundary_deff` on a converged field; batch-agnostic.
    """
    from .fvm import harmonic_mean

    ny, nx = x.shape[-2], x.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    dx = 1.0 / nx
    dy = 1.0 / ny
    cl = torch.as_tensor(c_left, dtype=x.dtype, device=x.device)
    cr = torch.as_tensor(c_right, dtype=x.dtype, device=x.device)

    # interior faces: q_j = sum_i h[i,j] * (x[i,j+1]-x[i,j]) * dy/dx
    h = harmonic_mean(d_field[..., :, :-1], d_field[..., :, 1:])
    q_int = torch.sum((h * (x[..., :, 1:] - x[..., :, :-1])).to(acc),
                      dim=-2) * (dy / dx)                    # (..., nx-1)
    # boundary cuts (half-cell Dirichlet distances)
    q_l = torch.sum((d_field[..., :, 0] * (x[..., :, 0] - cl)).to(acc),
                    dim=-1) * (dy / (dx / 2.0))
    q_r = torch.sum((d_field[..., :, -1] * (cr - x[..., :, -1])).to(acc),
                    dim=-1) * (dy / (dx / 2.0))
    q_all = torch.cat([q_l[..., None], q_int, q_r[..., None]], dim=-1)
    q_mean = torch.mean(q_all, dim=-1)
    return (q_mean / (cr - cl).to(acc)).to(x.dtype)
