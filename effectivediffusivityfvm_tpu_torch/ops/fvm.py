"""Matrix-free 5-point FVM operator for steady-state diffusion (torch port of
``effectivediffusivityfvm_tpu.ops.fvm``).

Discretization (documentation PDF §5.2, eq. 4-5): unit square, ``dx = 1/nx``,
``dy = 1/ny``; interior face conductance ``H * (face length) / (center
distance)`` with the harmonic mean ``H = 2/(1/Da + 1/Db)``; Dirichlet
``CL``/``CR`` on the left/right boundaries over a half cell, folded into the
diagonal and RHS; zero flux on top/bottom; masked cells become identity rows.

Every function here works on the trailing two dims, so the same code serves
one ``(ny, nx)`` image and a ``(B, ny, nx)`` batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "StencilCoeffs",
    "harmonic_mean",
    "fvm_coefficients",
    "neighbor_sum",
    "jacobi_sweep",
    "apply_operator",
    "residual",
    "equilibrate",
    "decouple_empty_rows",
]


class StencilCoeffs(NamedTuple):
    """Pentadiagonal system in structured-grid form; all tensors
    ``(..., ny, nx)``.

    ``a_w/a_e/a_n/a_s`` are positive conductances to the W/E/N/S neighbour;
    ``diag_inv`` is the guarded reciprocal diagonal (0 where diag == 0).
    """

    a_w: torch.Tensor
    a_e: torch.Tensor
    a_n: torch.Tensor
    a_s: torch.Tensor
    diag: torch.Tensor
    diag_inv: torch.Tensor
    b: torch.Tensor


def harmonic_mean(d_a: torch.Tensor, d_b: torch.Tensor) -> torch.Tensor:
    """dx/2-weighted harmonic mean in the reciprocal form ``2/(1/a + 1/b)``:
    a zero diffusivity on either side gives 0 (blocked face), not NaN."""
    return 2.0 / (1.0 / d_a + 1.0 / d_b)


def guarded_inverse(d: torch.Tensor) -> torch.Tensor:
    """``1/d`` where ``d > 0``, else 0."""
    return torch.where(d > 0, 1.0 / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def fvm_coefficients(
    d_field: torch.Tensor,
    c_left: float,
    c_right: float,
    mask: Optional[torch.Tensor] = None,
    symmetric: bool = False,
) -> StencilCoeffs:
    """Build stencil coefficients from a ``(..., ny, nx)`` diffusivity field.

    ``mask`` (bool, same shape): True cells become identity rows (diag 1,
    couplings 0, b 0).  ``symmetric=True`` also zeroes the couplings *into*
    masked cells, which keeps the exact solution and makes the operator SPD
    (CG and the symmetric-stencil kernels need that).
    """
    d = d_field
    ny, nx = d.shape[-2], d.shape[-1]
    dx = 1.0 / nx
    dy = 1.0 / ny

    hx = harmonic_mean(d[..., :, :-1], d[..., :, 1:]) * (dy / dx)
    hy = harmonic_mean(d[..., :-1, :], d[..., 1:, :]) * (dx / dy)

    zcol = torch.zeros_like(d[..., :, :1])
    zrow = torch.zeros_like(d[..., :1, :])
    a_w = torch.cat([zcol, hx], dim=-1)
    a_e = torch.cat([hx, zcol], dim=-1)
    a_n = torch.cat([zrow, hy], dim=-2)
    a_s = torch.cat([hy, zrow], dim=-2)

    bc_l = d[..., :, 0] * (dy / (dx / 2.0))
    bc_r = d[..., :, -1] * (dy / (dx / 2.0))

    diag = a_w + a_e + a_n + a_s
    diag[..., :, 0] += bc_l
    diag[..., :, -1] += bc_r

    b = torch.zeros_like(d)
    b[..., :, 0] += bc_l * c_left
    b[..., :, -1] += bc_r * c_right

    if mask is not None:
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        one = torch.ones((), dtype=d.dtype, device=d.device)
        a_w = torch.where(mask, zero, a_w)
        a_e = torch.where(mask, zero, a_e)
        a_n = torch.where(mask, zero, a_n)
        a_s = torch.where(mask, zero, a_s)
        diag = torch.where(mask, one, diag)
        b = torch.where(mask, zero, b)
        if symmetric:
            m = mask.to(torch.int8)
            a_w = torch.where(_shift_w(m) > 0, zero, a_w)
            a_e = torch.where(_shift_e(m) > 0, zero, a_e)
            a_n = torch.where(_shift_n(m) > 0, zero, a_n)
            a_s = torch.where(_shift_s(m) > 0, zero, a_s)

    return StencilCoeffs(a_w, a_e, a_n, a_s, diag, guarded_inverse(diag), b)


# Neighbour-value shifts on the trailing two dims (zero beyond the boundary).

def _shift_w(x: torch.Tensor) -> torch.Tensor:
    """Value of the west neighbour."""
    return torch.cat([torch.zeros_like(x[..., :, :1]), x[..., :, :-1]], dim=-1)


def _shift_e(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., :, 1:], torch.zeros_like(x[..., :, :1])], dim=-1)


def _shift_n(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]], dim=-2)


def _shift_s(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])], dim=-2)


def neighbor_sum(coeffs: StencilCoeffs, x: torch.Tensor) -> torch.Tensor:
    """``sum_nb a_nb * x_nb``, the off-diagonal product."""
    return (coeffs.a_w * _shift_w(x) + coeffs.a_e * _shift_e(x)
            + coeffs.a_n * _shift_n(x) + coeffs.a_s * _shift_s(x))


def jacobi_sweep(coeffs: StencilCoeffs, x: torch.Tensor,
                 omega: float) -> torch.Tensor:
    """One damped-Jacobi sweep ``(1-w) x + w (b + sum a x_nb) / diag``."""
    num = coeffs.b + neighbor_sum(coeffs, x)
    return (1.0 - omega) * x + omega * num * coeffs.diag_inv


def apply_operator(coeffs: StencilCoeffs, x: torch.Tensor) -> torch.Tensor:
    """``A x = diag x - sum a x_nb``."""
    return coeffs.diag * x - neighbor_sum(coeffs, x)


def residual(coeffs: StencilCoeffs, x: torch.Tensor) -> torch.Tensor:
    """Mean absolute flux imbalance ``mean(|b - A x|)`` over the grid."""
    return torch.mean(torch.abs(coeffs.b - apply_operator(coeffs, x)),
                      dim=(-2, -1))


def decouple_empty_rows(coeffs):
    """``coeffs`` (2D or 3D) with every row that has no conductance at all
    -- diag 0: a pore the flood fill reaches only across its periodic wrap,
    which the operator does not have -- made a decoupled identity row
    (diag 1, as the mask makes one; its couplings and b are 0 already).
    Its value then no longer matters to any other cell, and the deflated
    solves' equilibration has a unit scale there where ``1/sqrt(0)`` would
    turn them to NaN (as it does in the JAX package)."""
    empty = coeffs.diag == 0
    one = torch.ones_like(coeffs.diag)
    return coeffs._replace(diag=torch.where(empty, one, coeffs.diag),
                           diag_inv=torch.where(empty, one, coeffs.diag_inv))


def equilibrate(coeffs: StencilCoeffs):
    """Symmetric diagonal (Jacobi) equilibration: ``A' = S A S`` with
    ``S = diag(1/sqrt(diag))`` -- unit diagonal, every entry O(1).

    Low-precision Krylov iterations on raw extreme-contrast systems (Dg ~
    1e6) stall at once; on the equilibrated system they converge.  The
    transform keeps symmetry and the solution via ``x = S y``, ``b' = S b``.
    Returns ``(scaled_coeffs, s)`` with ``s = 1/sqrt(diag)`` (decoupled rows
    carry diag 1, so diag > 0).
    """
    s = torch.sqrt(coeffs.diag_inv)
    one = torch.ones_like(coeffs.diag)
    return StencilCoeffs(
        a_w=coeffs.a_w * s * _shift_w(s),
        a_e=coeffs.a_e * s * _shift_e(s),
        a_n=coeffs.a_n * s * _shift_n(s),
        a_s=coeffs.a_s * s * _shift_s(s),
        diag=one, diag_inv=one,
        b=coeffs.b * s,
    ), s
