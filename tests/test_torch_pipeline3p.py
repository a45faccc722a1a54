"""The 3-phase pipelines with the Krylov solvers, the port against the JAX
package on the CPU in float64: ``single_sim_3phase`` and
``batch_sim_3phase`` with ``dcg``, ``dmg`` and ``cgir`` on PNGs read from
disk, and the dp mesh route (``Devices: 2``, ``DP: 2``) with ``dmg`` on two
CPU devices.

The deflated solvers get each image's gas-component mask, ``dmg`` skips the
DCG homotopy pre-stages, the others walk them.  Both sides converge to the
same relative residual, so Deff agrees to rtol 1e-7; dmg's cycle is K2 on
both sides (the JAX package's in interpret mode, the port's plain
version).
"""

import logging

import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from effectivediffusivityfvm_tpu import config as jconfig
from effectivediffusivityfvm_tpu.pipeline import batch as jbatch
from effectivediffusivityfvm_tpu.pipeline import single as jsingle
from effectivediffusivityfvm_tpu.solvers import dmg as jdmg
from effectivediffusivityfvm_tpu_torch import config
from effectivediffusivityfvm_tpu_torch.pipeline import batch, single

# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)


def _img3(seed, n=32):
    """A 3-phase image: a quarter gas (0), half fluid (150), solid (255)."""
    rng = np.random.default_rng(seed)
    noise = ndimage.gaussian_filter(rng.standard_normal((n, n)), 2.0,
                                    mode="wrap")
    lo, hi = np.quantile(noise, [0.25, 0.75])
    return np.where(noise < lo, 0,
                    np.where(noise < hi, 150, 255)).astype(np.uint8)


def _cfg(mod, tmp_path, solver, tag, **kw):
    # Dg = 50: one homotopy pre-stage (DCG = 10) for the solvers that walk it
    base = dict(n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=50.0,
                convergence=1e-10, max_iter=3000, check_every=20,
                dtype="float64", criterion="relresidual", solver=solver,
                verbose=True, input_name=str(tmp_path / "img.png"),
                image_dir=str(tmp_path),
                output_name=str(tmp_path / f"{tag}.csv"))
    base.update(kw)
    return mod.SimulationConfig(**base)


def _pin_interpret_k2(monkeypatch):
    """Run the JAX package's dmg on its K2 Pallas cycle in interpret mode,
    the cycle the port runs (K2's plain version on the CPU), as the JAX
    package's own tests pin its Pallas engines for parity.  Off a TPU its
    auto rule would take the XLA cycle, which compiles for ~25 s here."""
    solve = jdmg._solve_dmg_jit

    def pinned(*args, **kw):
        return solve(*args, **dict(kw, use_pallas=True, pallas_interpret=True))
    monkeypatch.setattr(jdmg, "_solve_dmg_jit", pinned)


@pytest.fixture
def images(tmp_path):
    """One 40x32 image and three 24^2 ones, lossless PNG on disk."""
    Image.fromarray(_img3(1, 40)[:, :32]).save(tmp_path / "img.png",
                                                format="PNG")
    for i in range(3):
        # PNG content under the batch's .jpg names: PIL reads by content
        Image.fromarray(_img3(10 + i, 24)).save(tmp_path / f"{i:05d}.jpg",
                                                format="PNG")
    return tmp_path


@pytest.mark.parametrize("mode,solver", [
    ("single", "dcg"), ("single", "dmg"), ("single", "cgir"),
    ("batch", "dcg"), ("batch", "dmg"), ("batch", "cgir"),
    ("batch_dp2", "dmg")])
def test_3phase_pipelines_match_jax(images, caplog, monkeypatch, mode,
                                    solver):
    _pin_interpret_k2(monkeypatch)
    caplog.set_level(logging.INFO)
    kw = dict(batch_flag=True, num_images=3) if mode != "single" else {}
    if mode == "batch_dp2":
        kw.update(devices=2, dp=2)
    if solver == "cgir":
        kw["max_iter"] = 20             # outer refinement steps
    out = {}
    for tag, mod, run in (("jax", jconfig, None), ("torch", config, None)):
        cfg = _cfg(mod, images, solver, tag, **kw)
        if mode == "single":
            pipe = jsingle if tag == "jax" else single
            extra = {} if tag == "jax" else {"device": "cpu"}
            res = pipe.single_sim_3phase(cfg, **extra)
            deff, conv = np.array([res.deff]), np.array([res.conv])
        else:
            pipe = jbatch if tag == "jax" else batch
            extra = {} if tag == "jax" else {
                "device": "cpu", "mesh_devices": [torch.device("cpu")] * 2}
            table = pipe.batch_sim_3phase(cfg, **extra)
            deff, conv = table[:, 4], table[:, 7]
        out[tag] = (deff, conv, " ".join(r.getMessage()
                                          for r in caplog.records))
        caplog.clear()
    (deff_j, conv_j, log_j), (deff_t, conv_t, log_t) = out["jax"], out["torch"]
    np.testing.assert_allclose(deff_t, deff_j, rtol=1e-7)
    assert np.all(conv_t <= 1e-10) and np.all(conv_j <= 1e-10)
    assert np.all(np.isfinite(deff_t)) and np.all(deff_t > 0)
    stages = "Pre-Cond Stage" in log_t
    assert stages == (solver != "dmg")
    assert stages == ("Pre-Cond Stage" in log_j)
