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
CPU tensor it runs :func:`jacobi_sweeps_reference`.  The kernel has two
routes, chosen by :func:`jacobi_resident_fits` from the image's shape and
dtype alone: the resident route (one launch per call, the image held in a
thread-block cluster's registers and shared memory for all ``k`` sweeps)
and, for images the cluster cannot hold, the streaming route (one launch
per sweep).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..fvm import StencilCoeffs
from .vcycle import check_plane

__all__ = ["jacobi_sweeps_reference", "jacobi_sweeps",
           "jacobi_resident_fits", "resident_cluster"]

_CTYPE = {torch.float32: "f32", torch.float64: "f64"}

# The resident kernel's limits (csrc/jacobi.cu, which refuses a cluster that
# breaks them): a thread keeps a column segment of RES_SEG[itemsize] cells in
# registers, a CTA has at most RES_THREADS threads, a cluster at most
# RES_MAX_CLUSTER CTAs (the portable size).
RES_SEG = {4: 8, 8: 4}
RES_THREADS, RES_MAX_CLUSTER = 512, 8


def resident_cluster(ny: int, nx: int, itemsize: int = 4) -> int:
    """CTAs in the cluster that holds one ``ny x nx`` image on the resident
    route, or 0 if it takes the streaming route.  The image is cut into
    ``c`` bands of ``ceil(ny / c)`` rows, a CTA each; a band needs ``nx *
    ceil(rows / RES_SEG[itemsize])`` threads.  The smallest of ``c`` = 1,
    2, 4, 8 whose CTAs need at most 256 threads (so that up to three share
    an SM), else the smallest whose CTAs need at most ``RES_THREADS``."""
    seg = RES_SEG[itemsize]
    for cap in (256, RES_THREADS):
        c = 1
        while c <= RES_MAX_CLUSTER:
            rows = -(-ny // c)
            if nx * -(-rows // seg) <= cap:
                return c
            c *= 2
    return 0


def jacobi_resident_fits(ny: int, nx: int, itemsize: int = 4) -> bool:
    """Whether an ``ny x nx`` image of ``itemsize``-byte floats takes K3's
    resident route (one launch per call).  128^2 does, in float32 and
    float64 (a cluster of 8); 512^2 does not.  A rule by shape and dtype, as
    the JAX package's ``jacobi_fits_vmem``, never a fallback."""
    return resident_cluster(ny, nx, itemsize) > 0


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

    A CPU tensor runs the plain version.  A CUDA tensor launches the kernel
    or raises: where :func:`jacobi_resident_fits` holds (``(ny, nx)`` and
    the dtype's size), one launch of the resident route runs all ``k``
    sweeps (``jacobi_sweeps.resident_launches`` counts them); otherwise the
    streaming route launches once per sweep (``jacobi_sweeps.launches``).
    """
    k = int(k)
    if x.device.type == "cpu":
        return jacobi_sweeps_reference(coeffs, x, k, omega=omega,
                                       active=active)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi_sweeps: unsupported device {x.device}")
    act = _checked(coeffs, x, k, active)
    if k == 0:
        return x.clone()
    return _launch(coeffs, x, k, float(omega), act)


def _checked(coeffs, x, k, active):
    """Validate the arguments; return ``active`` as int32 (or None)."""
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
    if active is None:
        return None
    if tuple(active.shape) != (x.shape[0],) or active.device != x.device:
        raise ValueError(f"active: shape {tuple(active.shape)} on "
                         f"{active.device}, expected ({x.shape[0]},) on "
                         f"{x.device}")
    return active.ne(0).to(torch.int32).contiguous()


def _launch(coeffs, x, k, omega, act):
    """The route by the size rule: one resident launch, or ``k``
    streaming launches."""
    _, ny, nx = x.shape
    if jacobi_resident_fits(ny, nx, x.element_size()):
        return _resident(coeffs, x, k, omega, act)
    return _streaming(coeffs, x, k, omega, act)


def _args(coeffs, x):
    return (coeffs.a_w.data_ptr(), coeffs.a_n.data_ptr(),
            coeffs.diag_inv.data_ptr(), coeffs.b.data_ptr(), x.data_ptr())


def _resident(coeffs, x, k, omega, act):
    """All ``k >= 1`` sweeps in one launch of the cluster-resident kernel."""
    from ._build import check, load_library

    lib = load_library()
    bsz, ny, nx = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"deff_jacobi_resident_{_CTYPE[x.dtype]}")
        status = fn(bsz, ny, nx, resident_cluster(ny, nx, x.element_size()),
                    *_args(coeffs, x), out.data_ptr(),
                    None if act is None else act.data_ptr(), k, omega,
                    stream)
    check(status, "jacobi_sweeps (resident)")
    jacobi_sweeps.resident_launches += 1
    return out


def _streaming(coeffs, x, k, omega, act):
    """``k >= 1`` sweeps, one launch each, through L2/HBM."""
    from ._build import check, load_library

    lib = load_library()
    bsz, ny, nx = x.shape
    out = torch.empty_like(x)
    scratch = torch.empty_like(x) if k > 1 else out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"deff_jacobi_sweeps_{_CTYPE[x.dtype]}")
        status = fn(bsz, ny, nx, *_args(coeffs, x), out.data_ptr(),
                    scratch.data_ptr(),
                    None if act is None else act.data_ptr(), k, omega,
                    stream)
    check(status, "jacobi_sweeps (streaming)")
    jacobi_sweeps.launches += k
    return out


jacobi_sweeps.launches = 0
jacobi_sweeps.resident_launches = 0
