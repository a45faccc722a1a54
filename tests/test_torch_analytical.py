"""Analytical oracles through the port (documentation PDF §5.3), the
counterparts of ``tests/test_analytical.py``:

Parallel slabs:  Deff = eps*Df + (1-eps)*Ds                (eq. 7)
Series slabs:    Deff = (eps/Df + (1-eps)/Ds)^-1           (eq. 8)
Thin-phase series: 3% solid slab, contrast 1e6, Deff = 33.33 (§5.3.1)
3-phase parallel 30/40/30, Dg = 1,237,500: Deff = 371,250.4 (§5.3.2)

These cases are exact for the FVM discretization (piecewise-constant fields
aligned with the mesh).  The JAX tests run Jacobi to 3e6 sweeps; the port
runs them in float64 with ``solver="mgcg"`` (the plain versions of K1/K2
here), which for an analytic oracle changes nothing but the time.
"""

import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
from effectivediffusivityfvm_tpu_torch.io.images import (
    parallel_slab, series_slab, three_phase_parallel_slab)
from effectivediffusivityfvm_tpu_torch.models import phases
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.pipeline.single import (
    single_sim, single_sim_3phase)
from effectivediffusivityfvm_tpu_torch.solvers.multigrid import solve_mgcg

torch.set_num_threads(1)


def solve_image(img, df, ds, tol):
    classes = phases.two_phase_classes(img)
    d = torch.tensor(phases.d_field_from_classes(classes, df, ds,
                                                 dtype=np.float64))
    ny, nx = d.shape
    x0 = (torch.arange(nx, dtype=torch.float64) / nx).expand(ny, nx)
    res = solve_mgcg(fvm.fvm_coefficients(d, 0.0, 1.0),
                     make_flux_spec(d, 0.0, 1.0), x0, tol=tol,
                     max_iter=2000, check_every=10, criterion="relresidual")
    assert float(res.conv) <= tol
    return float(res.deff)


@pytest.mark.parametrize("eps", [0.1, 0.3, 0.5, 0.7, 0.9])
@pytest.mark.parametrize("ds", [1e-1, 1e-3])
def test_parallel_slab_sweep(eps, ds):
    deff = solve_image(parallel_slab(50, eps), 1.0, ds, tol=1e-12)
    np.testing.assert_allclose(deff, eps * 1.0 + (1 - eps) * ds, rtol=1e-6)


@pytest.mark.parametrize("eps", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("ds", [1e-1, 1e-2])
def test_series_slab_sweep(eps, ds):
    deff = solve_image(series_slab(50, eps), 1.0, ds, tol=1e-12)
    np.testing.assert_allclose(deff, 1.0 / (eps / 1.0 + (1 - eps) / ds),
                               rtol=1e-6)


def test_thin_phase_high_contrast():
    """PDF §5.3.1: 3% solid slab in series, fluid/solid contrast 1e6:
    Deff = (0.97/1e6 + 0.03/1)^-1 = 33.33 in raw units (the CSV column is
    normalized by D_fluid), through ``single_sim`` and its DCF continuation
    ladder (stages 100, 1e4, 1e6)."""
    img = series_slab(100, 0.97)
    cfg = SimulationConfig(
        n_phase=2, d_fluid=1e6, d_solid=1.0, convergence=1e-12,
        max_iter=2000, check_every=10, dtype="float64",
        criterion="relresidual", solver="mgcg")
    res = single_sim(cfg, img=img, write_output=False, device="cpu")
    assert res.conv <= 1e-12
    deff_raw = res.deff * cfg.d_fluid
    expected = 1.0 / (0.97 / 1e6 + 0.03 / 1.0)
    np.testing.assert_allclose(deff_raw, expected, rtol=1e-4)
    np.testing.assert_allclose(expected, 33.33, rtol=1e-3)


def test_three_phase_parallel_headline():
    """PDF §5.3.2: 30/40/30 solid/fluid/gas parallel slabs, Dg = 1,237,500,
    Ds = 0, Df = 1 -> Deff = 371,250.4, through ``single_sim_3phase`` and
    its DCG homotopy."""
    img = three_phase_parallel_slab(100, svf=0.3, lvf=0.4)
    cfg = SimulationConfig(
        n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=1_237_500.0,
        convergence=1e-12, max_iter=2000, check_every=10, dtype="float64",
        criterion="relresidual", solver="mgcg")
    res = single_sim_3phase(cfg, img=img, write_output=False, device="cpu")
    np.testing.assert_allclose(res.deff, 0.4 * 1.0 + 0.3 * 1_237_500.0,
                               rtol=1e-5)
    assert res.svf == pytest.approx(0.3)
    assert res.lvf == pytest.approx(0.4)
    assert res.path_flag
