"""Matrix-free 7-point FVM operator for 3D voxel domains (torch port of
``effectivediffusivityfvm_tpu.ops.fvm3d``).

The 2D discretization of :mod:`.fvm` extended to ``(nz, ny, nx)`` fields
with the same conventions:

  * unit cube, ``dx = 1/nx, dy = 1/ny, dz = 1/nz``;
  * transport along x: Dirichlet ``CL``/``CR`` on the x boundaries over
    half-cell distances with the cell's own diffusivity;
  * zero flux on all y and z boundaries;
  * interface conductance = harmonic mean (reciprocal form) * face area /
    center distance (x faces: dy*dz/dx, y faces: dx*dz/dy, z: dx*dy/dz);
  * masked voxels are identity rows, with the same optional symmetrization
    for Krylov solvers.

Neighbour key: W/E along x (last axis), N/S along y (axis -2), U/D along z
(axis -3).  Every function works on the trailing three dims, so the same
code serves one volume and a ``(B, nz, ny, nx)`` batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fvm import guarded_inverse, harmonic_mean

__all__ = [
    "StencilCoeffs3D",
    "fvm_coefficients_3d",
    "neighbor_sum_3d",
    "jacobi_sweep_3d",
    "apply_operator_3d",
    "residual_3d",
    "equilibrate_3d",
    "FluxSpec3D",
    "make_flux_spec_3d",
    "boundary_deff_3d",
]


class StencilCoeffs3D(NamedTuple):
    """Heptadiagonal system in structured-grid form; all tensors
    ``(..., nz, ny, nx)``."""

    a_w: torch.Tensor
    a_e: torch.Tensor
    a_n: torch.Tensor   # y-1 neighbour
    a_s: torch.Tensor   # y+1
    a_u: torch.Tensor   # z-1
    a_d: torch.Tensor   # z+1
    diag: torch.Tensor
    diag_inv: torch.Tensor
    b: torch.Tensor


def _shift(x: torch.Tensor, axis: int, off: int) -> torch.Tensor:
    """Neighbour values along ``axis`` with zero fill (``off = -1``: the
    value of the previous-index neighbour)."""
    n = x.shape[axis]
    z = torch.zeros_like(x.narrow(axis, 0, 1))
    if off == -1:
        return torch.cat([z, x.narrow(axis, 0, n - 1)], dim=axis)
    return torch.cat([x.narrow(axis, 1, n - 1), z], dim=axis)


def fvm_coefficients_3d(
    d_field: torch.Tensor,
    c_left: float,
    c_right: float,
    mask: Optional[torch.Tensor] = None,
    symmetric: bool = False,
) -> StencilCoeffs3D:
    """Build the 7-point coefficients of a ``(..., nz, ny, nx)`` diffusivity
    volume; ``mask``/``symmetric`` as in :func:`.fvm.fvm_coefficients`."""
    d = d_field
    nz, ny, nx = d.shape[-3:]
    dx, dy, dz = 1.0 / nx, 1.0 / ny, 1.0 / nz

    hx = harmonic_mean(d[..., :, :, :-1], d[..., :, :, 1:]) * (dy * dz / dx)
    hy = harmonic_mean(d[..., :, :-1, :], d[..., :, 1:, :]) * (dx * dz / dy)
    hz = harmonic_mean(d[..., :-1, :, :], d[..., 1:, :, :]) * (dx * dy / dz)

    zx = torch.zeros_like(d[..., :, :, :1])
    zy = torch.zeros_like(d[..., :, :1, :])
    zz = torch.zeros_like(d[..., :1, :, :])

    a_w = torch.cat([zx, hx], dim=-1)
    a_e = torch.cat([hx, zx], dim=-1)
    a_n = torch.cat([zy, hy], dim=-2)
    a_s = torch.cat([hy, zy], dim=-2)
    a_u = torch.cat([zz, hz], dim=-3)
    a_d = torch.cat([hz, zz], dim=-3)

    bc_l = d[..., :, :, 0] * (dy * dz / (dx / 2.0))   # (..., nz, ny)
    bc_r = d[..., :, :, -1] * (dy * dz / (dx / 2.0))

    diag = a_w + a_e + a_n + a_s + a_u + a_d
    diag[..., :, :, 0] += bc_l
    diag[..., :, :, -1] += bc_r

    b = torch.zeros_like(d)
    b[..., :, :, 0] += bc_l * c_left
    b[..., :, :, -1] += bc_r * c_right

    if mask is not None:
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        one = torch.ones((), dtype=d.dtype, device=d.device)
        a_w, a_e, a_n, a_s, a_u, a_d = (
            torch.where(mask, zero, a) for a in (a_w, a_e, a_n, a_s, a_u, a_d))
        diag = torch.where(mask, one, diag)
        b = torch.where(mask, zero, b)
        if symmetric:
            m = mask.to(torch.int8)
            a_w = torch.where(_shift(m, -1, -1) > 0, zero, a_w)
            a_e = torch.where(_shift(m, -1, +1) > 0, zero, a_e)
            a_n = torch.where(_shift(m, -2, -1) > 0, zero, a_n)
            a_s = torch.where(_shift(m, -2, +1) > 0, zero, a_s)
            a_u = torch.where(_shift(m, -3, -1) > 0, zero, a_u)
            a_d = torch.where(_shift(m, -3, +1) > 0, zero, a_d)

    return StencilCoeffs3D(a_w, a_e, a_n, a_s, a_u, a_d, diag,
                           guarded_inverse(diag), b)


def neighbor_sum_3d(c: StencilCoeffs3D, x: torch.Tensor) -> torch.Tensor:
    """``sum_nb a_nb * x_nb``, the off-diagonal product."""
    return (c.a_w * _shift(x, -1, -1) + c.a_e * _shift(x, -1, +1)
            + c.a_n * _shift(x, -2, -1) + c.a_s * _shift(x, -2, +1)
            + c.a_u * _shift(x, -3, -1) + c.a_d * _shift(x, -3, +1))


def jacobi_sweep_3d(c: StencilCoeffs3D, x: torch.Tensor,
                    omega: float) -> torch.Tensor:
    """One damped-Jacobi sweep ``(1-w) x + w (b + sum a x_nb) / diag``."""
    num = c.b + neighbor_sum_3d(c, x)
    return (1.0 - omega) * x + omega * num * c.diag_inv


def apply_operator_3d(c: StencilCoeffs3D, x: torch.Tensor) -> torch.Tensor:
    """``A x = diag x - sum a x_nb``."""
    return c.diag * x - neighbor_sum_3d(c, x)


def residual_3d(c: StencilCoeffs3D, x: torch.Tensor) -> torch.Tensor:
    """Mean absolute flux imbalance ``mean(|b - A x|)`` over the volume."""
    return torch.mean(torch.abs(c.b - apply_operator_3d(c, x)),
                      dim=(-3, -2, -1))


def equilibrate_3d(c: StencilCoeffs3D):
    """Symmetric diagonal equilibration ``A' = S A S``, ``S =
    diag(1/sqrt(diag))``; returns ``(coeffs', s)``."""
    s = torch.sqrt(c.diag_inv)
    one = torch.ones_like(c.diag)
    return StencilCoeffs3D(
        a_w=c.a_w * s * _shift(s, -1, -1),
        a_e=c.a_e * s * _shift(s, -1, +1),
        a_n=c.a_n * s * _shift(s, -2, -1),
        a_s=c.a_s * s * _shift(s, -2, +1),
        a_u=c.a_u * s * _shift(s, -3, -1),
        a_d=c.a_d * s * _shift(s, -3, +1),
        diag=one, diag_inv=one,
        b=c.b * s,
    ), s


class FluxSpec3D(NamedTuple):
    d_left: torch.Tensor     # (..., nz, ny)
    d_right: torch.Tensor
    c_left: torch.Tensor
    c_right: torch.Tensor
    inv_half_dx: torch.Tensor


def make_flux_spec_3d(d_field: torch.Tensor, c_left, c_right) -> FluxSpec3D:
    nx = d_field.shape[-1]
    kw = dict(dtype=d_field.dtype, device=d_field.device)
    return FluxSpec3D(
        d_left=d_field[..., :, :, 0],
        d_right=d_field[..., :, :, -1],
        c_left=torch.as_tensor(c_left, **kw),
        c_right=torch.as_tensor(c_right, **kw),
        inv_half_dx=torch.as_tensor(2.0 * nx, **kw),
    )


def boundary_deff_3d(spec: FluxSpec3D, x: torch.Tensor) -> torch.Tensor:
    """Deff from the x-boundary fluxes, averaged over the ``(nz, ny)`` face
    (the flux sums divided by the number of boundary cells)."""
    nz, ny = x.shape[-3], x.shape[-2]
    acc = torch.promote_types(x.dtype, torch.float32)
    cl = torch.as_tensor(spec.c_left)[..., None, None]
    cr = torch.as_tensor(spec.c_right)[..., None, None]
    ihdx = torch.as_tensor(spec.inv_half_dx)[..., None, None]
    mfl = (spec.d_left * (x[..., :, :, 0] - cl) * ihdx).to(acc)
    mfr = (spec.d_right * (cr - x[..., :, :, -1]) * ihdx).to(acc)
    q = (torch.sum(mfl, dim=(-2, -1)) + torch.sum(mfr, dim=(-2, -1))) \
        / (2.0 * ny * nz)
    denom = torch.as_tensor(spec.c_right - spec.c_left).to(acc)
    return (q / denom).to(x.dtype)
