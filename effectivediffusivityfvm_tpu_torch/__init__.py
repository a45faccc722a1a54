"""effectivediffusivityfvm_tpu_torch — the PyTorch/CUDA port of
``effectivediffusivityfvm_tpu``.

The port keeps the JAX package's module paths and function names so each
function's counterpart is easy to find.  It imports ``torch``, ``numpy`` and
``scipy`` only; the JAX package stays the reference the port is tested
against.

Ported so far: the batched 2-phase 2D solve — image classes → diffusivity
field → 5-point FVM assembly → multigrid-preconditioned CG
(:func:`solvers.multigrid.solve_mgcg_batched`, whose V-cycle and fused CG
iterations run as hand-written CUDA kernels on the GPU) → boundary-flux
Deff.
"""

from .models.phases import d_field_from_classes, two_phase_classes
from .ops.flux import BoundaryFluxSpec, boundary_deff, make_flux_spec
from .ops.fvm import StencilCoeffs, fvm_coefficients, jacobi_sweep, residual
from .solvers.driver import SolveResult
from .solvers.multigrid import solve_mgcg, solve_mgcg_batched

__version__ = "0.1.0"

__all__ = [
    "two_phase_classes",
    "d_field_from_classes",
    "StencilCoeffs",
    "fvm_coefficients",
    "jacobi_sweep",
    "residual",
    "BoundaryFluxSpec",
    "boundary_deff",
    "make_flux_spec",
    "SolveResult",
    "solve_mgcg",
    "solve_mgcg_batched",
    "__version__",
]
