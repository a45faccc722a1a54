"""The plain reference of the 2-phase effective-diffusivity problem.

Written from the upstream documentation (EffectiveDiffusivityFVM, PDF §2.2,
§5.2 eq. 4-6) in plain PyTorch, independent of the code under test:

* a pixel below 150 is fluid, any other pixel solid; porosity is the fluid
  share of the pixels;
* unit square, ``dx = 1/nx``, ``dy = 1/ny``; an interior face carries the
  harmonic mean ``2 / (1/Da + 1/Db)`` of its two cells times face length
  over centre distance; Dirichlet ``c_left``/``c_right`` on the left and
  right walls over half a cell; no flux through the top and bottom;
* Deff is the mean of the left and right wall fluxes per row (eq. 6);
* PathFlag: some 4-connected fluid component, periodic in y, touches both
  the left and the right column.

Every function takes ``(..., ny, nx)`` tensors and computes in their dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLUID_BELOW = 150


class System(NamedTuple):
    """``A x = b`` with ``(A x)_i = diag_i x_i - sum_nb a_nb x_nb``."""

    a_w: torch.Tensor
    a_e: torch.Tensor
    a_n: torch.Tensor
    a_s: torch.Tensor
    diag: torch.Tensor
    b: torch.Tensor


def fluid(img: torch.Tensor) -> torch.Tensor:
    return img < FLUID_BELOW


def porosity(img: torch.Tensor) -> torch.Tensor:
    """Fluid share of each image, in float64."""
    return fluid(img).to(torch.float64).mean(dim=(-2, -1))


def diffusivity(is_fluid: torch.Tensor, d_fluid: float, d_solid: float,
                dtype=torch.float64) -> torch.Tensor:
    one = torch.ones((), dtype=dtype, device=is_fluid.device)
    return torch.where(is_fluid, d_fluid * one, d_solid * one)


def system(d: torch.Tensor, c_left: float, c_right: float) -> System:
    ny, nx = d.shape[-2:]
    dx, dy = 1.0 / nx, 1.0 / ny
    zero = torch.zeros_like(d)
    hx = 2.0 / (1.0 / d[..., :, :-1] + 1.0 / d[..., :, 1:]) * (dy / dx)
    hy = 2.0 / (1.0 / d[..., :-1, :] + 1.0 / d[..., 1:, :]) * (dx / dy)
    a_w, a_e, a_n, a_s = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    a_w[..., :, 1:] = hx
    a_e[..., :, :-1] = hx
    a_n[..., 1:, :] = hy
    a_s[..., :-1, :] = hy
    wall = dy / (dx / 2.0)
    diag = a_w + a_e + a_n + a_s
    diag[..., :, 0] += d[..., :, 0] * wall
    diag[..., :, -1] += d[..., :, -1] * wall
    b = zero.clone()
    b[..., :, 0] = d[..., :, 0] * wall * c_left
    b[..., :, -1] = d[..., :, -1] * wall * c_right
    return System(a_w, a_e, a_n, a_s, diag, b)


def neighbours(s: System, x: torch.Tensor) -> torch.Tensor:
    """``sum_nb a_nb x_nb`` (zero beyond the walls)."""
    out = torch.zeros_like(x)
    out[..., :, 1:] += s.a_w[..., :, 1:] * x[..., :, :-1]
    out[..., :, :-1] += s.a_e[..., :, :-1] * x[..., :, 1:]
    out[..., 1:, :] += s.a_n[..., 1:, :] * x[..., :-1, :]
    out[..., :-1, :] += s.a_s[..., :-1, :] * x[..., 1:, :]
    return out


def mean_abs_residual(s: System, x: torch.Tensor) -> torch.Tensor:
    """``mean |b - A x|`` over each grid."""
    r = s.b - (s.diag * x - neighbours(s, x))
    return r.abs().mean(dim=(-2, -1))


def deff(d: torch.Tensor, x: torch.Tensor, c_left: float,
         c_right: float) -> torch.Tensor:
    """Eq. 6: the wall fluxes of each row, left and right, averaged."""
    ny, nx = x.shape[-2:]
    left = d[..., :, 0] * (x[..., :, 0] - c_left) * (2.0 * nx)
    right = d[..., :, -1] * (c_right - x[..., :, -1]) * (2.0 * nx)
    return (left.sum(-1) + right.sum(-1)) / (2.0 * ny) / (c_right - c_left)


def linear_start(shape, c_left: float, c_right: float, dtype,
                 device) -> torch.Tensor:
    """``x[i, j] = j / nx * (c_right - c_left) + c_left``."""
    nx = shape[-1]
    row = torch.arange(nx, dtype=dtype, device=device) / nx
    return (row * (c_right - c_left) + c_left).expand(shape).clone()


def path_flag(is_fluid: np.ndarray) -> bool:
    """Left-to-right percolation of one ``(ny, nx)`` fluid mask through
    4-connected cells, periodic in y: a breadth-first search from the left
    column."""
    ny, nx = is_fluid.shape
    seen = np.zeros((ny, nx), bool)
    frontier = [(i, 0) for i in range(ny) if is_fluid[i, 0]]
    for i, j in frontier:
        seen[i, j] = True
    while frontier:
        nxt = []
        for i, j in frontier:
            for a, c in (((i - 1) % ny, j), ((i + 1) % ny, j), (i, j - 1),
                         (i, j + 1)):
                if 0 <= c < nx and is_fluid[a, c] and not seen[a, c]:
                    seen[a, c] = True
                    nxt.append((a, c))
        frontier = nxt
    return bool(seen[:, -1].any())
