"""effectivediffusivityfvm_tpu_torch — the PyTorch/CUDA port of
``effectivediffusivityfvm_tpu``.

The port keeps the JAX package's module paths and function names so each
function's counterpart is easy to find.  It imports ``torch``, ``numpy`` and
``scipy`` only (PIL when it reads an image); the JAX package stays the
reference the port is tested against.

Ported so far:

* the reference CLI path, ``python -m effectivediffusivityfvm_tpu_torch.cli
  input.txt``: configuration, image decoding, flood fill, the single and
  batch pipelines (2- and 3-phase) and the reference's CSV writers;
* the solvers ``jacobi`` (plain PyTorch sweeps), ``jacobi_pallas`` (the
  hand-written CUDA Jacobi kernel) and ``mgcg`` (multigrid-preconditioned
  CG, whose V-cycle and fused CG iterations run as hand-written CUDA
  kernels; float32 grids from 1280² up take the banded engine, with an
  optional matrix-free level 0);
* the image → diffusivity field → 5-point FVM assembly → boundary-flux Deff
  chain under them;
* the 3D voxel path: ``.npy``/``.npz`` volumes through the CLI into the
  volume pipelines, the 7-point assembly and ``solve_mgcg_3d*`` on the
  banded fused 3D engine, whose V-cycle and CG iterations run as
  hand-written CUDA kernels;
* the row-sharded 2D path (``parallel/``): a mesh of torch devices driven
  from one process, the sharded Jacobi and MGCG solves (the latter on
  hand-written CUDA kernels for one shard's cycle level and its CG
  passes), and the ``Devices``/``DP``/``SP`` routes of the batch pipeline;
* the auxiliary modules: ``ops/autodiff.py`` (Deff as a differentiable
  function of the D field, a ``torch.autograd.Function`` whose backward is
  one adjoint solve on the same MGCG engine and kernels),
  ``utils/checkpoint.py`` (npz checkpoints in the JAX package's layout,
  segmented and resumable solves, ``AsyncSaver``), ``utils/profiling.py``
  (``torch.profiler`` traces, ``benchmark_solver``, ``RunManifest``),
  ``utils/debug.py``, ``viz.py`` and ``entry.py`` (the twin of
  ``__graft_entry__.entry()``).

The port does everything the JAX package does except the benchmark
scripts' twins, the orbax checkpoint backend, the TPU-era probes and the
Mosaic-only machinery (ROADMAP).

Everything runs on the CUDA device by default; pass ``device="cpu"`` to the
pipelines (or CPU tensors to the solvers) to run the kernels' plain PyTorch
versions instead.
"""

from .config import SimulationConfig, parse_input_file
from .models.phases import d_field_from_classes, two_phase_classes
from .ops.flux import BoundaryFluxSpec, boundary_deff, make_flux_spec
from .ops.fvm import StencilCoeffs, fvm_coefficients, jacobi_sweep, residual
from .pipeline.batch import batch_sim, batch_sim_3phase
from .pipeline.single import single_sim, single_sim_3phase
from .pipeline.volume import (volume_batch_sim, volume_batch_sim_3phase,
                              volume_sim, volume_sim_3phase)
from .solvers.driver import SolveResult
from .solvers.jacobi import solve_jacobi, solve_jacobi_batched
from .solvers.multigrid import solve_mgcg, solve_mgcg_batched
from .solvers.solvers3d import solve_mgcg_3d, solve_mgcg_3d_batched

__version__ = "0.1.0"

__all__ = [
    "SimulationConfig",
    "parse_input_file",
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
    "solve_jacobi",
    "solve_jacobi_batched",
    "solve_mgcg",
    "solve_mgcg_batched",
    "single_sim",
    "single_sim_3phase",
    "batch_sim",
    "batch_sim_3phase",
    "solve_mgcg_3d",
    "solve_mgcg_3d_batched",
    "volume_sim",
    "volume_sim_3phase",
    "volume_batch_sim",
    "volume_batch_sim_3phase",
    "__version__",
]
