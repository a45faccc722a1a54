"""The forward step of the JAX package's ``__graft_entry__.entry()``: 100
fixed damped-Jacobi sweeps on a batch of random 2-phase images, then the
boundary-flux Deff.

    from effectivediffusivityfvm_tpu_torch.entry import entry
    forward, args = entry()             # on the card; entry("cpu") here
    deff = forward(*args)               # (4,)

The JAX step runs XLA sweeps (``fvm.jacobi_sweep`` in a ``fori_loop``),
not the Jacobi kernel, so the twin runs the plain sweep too.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import phases
from .ops import fvm
from .ops.flux import boundary_deff, make_flux_spec

__all__ = ["problem", "entry"]

SWEEPS, OMEGA = 100, 2.0 / 3.0


def problem(batch, ny, nx, dtype, device, seed=0):
    """``(coeffs, spec, x0)`` of ``batch`` random ``(ny, nx)`` images (a
    pixel is fluid with probability 0.45, D 1 there and 1e-6 elsewhere;
    x0 the linear ramp), as ``__graft_entry__._problem`` builds them."""
    rng = np.random.default_rng(seed)
    imgs = (rng.random((batch, ny, nx)) < 0.45).astype(np.uint8) * 255
    classes = np.stack([phases.two_phase_classes(im) for im in imgs])
    d = torch.tensor(phases.d_field_from_classes(classes, 1.0, 1e-6),
                     dtype=dtype, device=device)
    x0 = (torch.arange(nx, dtype=dtype, device=device) / nx).expand(
        batch, ny, nx)
    return fvm.fvm_coefficients(d, 0.0, 1.0), make_flux_spec(d, 0.0, 1.0), x0


def forward(coeffs, spec, x):
    """``SWEEPS`` damped-Jacobi sweeps at ``OMEGA`` from ``x``, then Deff."""
    for _ in range(SWEEPS):
        x = fvm.jacobi_sweep(coeffs, x, OMEGA)
    return boundary_deff(spec, x)


def entry(device="cuda"):
    """``(forward, (coeffs, spec, x0))``: B=4 x 128^2 float32, seed 0."""
    return forward, problem(4, 128, 128, torch.float32, torch.device(device))
