"""K3: ``k`` damped-Jacobi sweeps on a ``(B, ny, nx)`` batch — the CUDA
kernel (``csrc/jacobi.cu``) and its plain PyTorch version.

Replaces ``effectivediffusivityfvm_tpu/ops/kernels/jacobi_vmem.py``
(``jacobi_sweeps_pallas``), the reference's ``updateX_SOR``
(Deff2D.cuh:69-92).  Each sweep is

    num = b + a_w x_w + east + a_n x_n + south
    x'  = (1 - omega) x + omega num diag_inv

with the east term ``a_w[i, j+1] x[i, j+1]`` and the south term
``a_n[i+1, j] x[i+1, j]``, zero beyond the grid (the TPU kernel's
``pltpu.roll`` wrap-around times the zero boundary conductance gives the
same).  Only ``a_w``, ``a_n``, ``diag_inv`` and ``b`` are read, so the
system must be the symmetric assembly (unmasked, or ``symmetric=True``);
the sums run in this order in both versions.

On a CUDA tensor :func:`jacobi_sweeps` launches the kernel (or raises); on a
CPU tensor it runs :func:`jacobi_sweeps_reference`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..fvm import StencilCoeffs
from .vcycle import check_plane

__all__ = ["jacobi_sweeps_reference", "jacobi_sweeps"]

_CTYPE = {torch.float32: "f32", torch.float64: "f64"}


def _sweep(coeffs: StencilCoeffs, x: torch.Tensor, omega: float):
    aw, an = coeffs.a_w, coeffs.a_n
    xw = F.pad(x[..., :, :-1], (1, 0))
    xn = F.pad(x[..., :-1, :], (0, 0, 1, 0))
    east = F.pad((aw * x)[..., :, 1:], (0, 1))
    south = F.pad((an * x)[..., 1:, :], (0, 0, 0, 1))
    num = coeffs.b + aw * xw + east + an * xn + south
    return (1.0 - omega) * x + omega * num * coeffs.diag_inv


def jacobi_sweeps_reference(coeffs: StencilCoeffs, x: torch.Tensor, k: int,
                            *, omega: float = 2.0 / 3.0,
                            active: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version: ``k`` sweeps, frozen images (``active == 0``)
    returned unchanged.  Always a fresh tensor."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    y = x.clone()
    for _ in range(k):
        y = _sweep(coeffs, y, omega)
    if active is not None:
        y = torch.where(active.ne(0)[:, None, None], y, x)
    return y


def jacobi_sweeps(coeffs: StencilCoeffs, x: torch.Tensor, k: int, *,
                  omega: float = 2.0 / 3.0,
                  active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run ``k`` damped-Jacobi sweeps on a ``(B, ny, nx)`` batch.

    Args:
      coeffs: the system, planes ``(B, ny, nx)`` (``a_w``, ``a_n``,
        ``diag_inv`` and ``b`` are read).
      x: the field, ``(B, ny, nx)``, float32 or float64; not modified.
      k: sweeps, a host integer ``>= 0``.
      active: optional ``(B,)``; images where it is 0 do no work and come
        back bitwise unchanged.
    Returns:
      a fresh ``(B, ny, nx)`` tensor.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    once per sweep (``jacobi_sweeps.launches`` counts the launches) or
    raises.
    """
    k = int(k)
    if x.device.type == "cpu":
        return jacobi_sweeps_reference(coeffs, x, k, omega=omega,
                                       active=active)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi_sweeps: unsupported device {x.device}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if x.dtype not in _CTYPE:
        raise ValueError(f"jacobi_sweeps takes float32 or float64, not "
                         f"{x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, ny, nx), got {tuple(x.shape)}")
    check_plane(x, "x", x.shape, x)
    for f in ("a_w", "a_n", "diag_inv", "b"):
        check_plane(getattr(coeffs, f), f, x.shape, x)
    bsz, ny, nx = x.shape
    act = None
    if active is not None:
        if tuple(active.shape) != (bsz,) or active.device != x.device:
            raise ValueError(f"active: shape {tuple(active.shape)} on "
                             f"{active.device}, expected ({bsz},) on "
                             f"{x.device}")
        act = active.ne(0).to(torch.int32).contiguous()
    if k == 0:
        return x.clone()
    from ._build import check, load_library

    lib = load_library()
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if k > 1 else out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"deff_jacobi_sweeps_{_CTYPE[x.dtype]}")
        status = fn(bsz, ny, nx, coeffs.a_w.data_ptr(), coeffs.a_n.data_ptr(),
                    coeffs.diag_inv.data_ptr(), coeffs.b.data_ptr(),
                    x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    None if act is None else act.data_ptr(), k, float(omega),
                    stream)
    check(status, "jacobi_sweeps")
    jacobi_sweeps.launches += k
    return out


jacobi_sweeps.launches = 0
