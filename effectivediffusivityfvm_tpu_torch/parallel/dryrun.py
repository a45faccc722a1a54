"""A dry run of the sharded paths on a list of devices: the twin of the
JAX package's ``__graft_entry__.dryrun_multichip`` (its 2D and 3D legs).

    from effectivediffusivityfvm_tpu_torch.parallel.dryrun import \\
        dryrun_multichip
    dryrun_multichip([torch.device("cuda", 0)] * 4)    # four shards, one card
    dryrun_multichip([torch.device("cpu")] * 8, device="cpu")

It runs, on tiny shapes: the dp x sp Jacobi solve, the z-slab sharded 3D
CG, the sp-sharded fused MGCG against the unsharded solve, and
``batch_sim`` on a dp mesh with Jacobi and with mgcg; it raises on a
non-finite or disagreeing result and returns one line per part.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np
import torch

from ..config import SimulationConfig
from ..entry import problem as _problem
from ..io.images import parallel_slab
from ..ops import fvm, fvm3d
from ..ops.flux import make_flux_spec
from ..pipeline.batch import batch_sim
from ..solvers.multigrid import solve_mgcg
from .halo import sharded_solve_jacobi, sharded_solve_mgcg
from .halo3d import sharded_solve_cg_3d
from .mesh import make_mesh

__all__ = ["dryrun_multichip"]


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(devices: Sequence, device=None,
                     out_dir: str = None) -> List[str]:
    """Run the sharded paths once on a mesh over ``devices``; inputs and
    results on ``device`` (default: ``devices[0]``), CSVs under ``out_dir``
    (default: the working directory)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    dev = torch.device(device) if device is not None else devices[0]
    out_dir = out_dir or "."
    lines = []

    dp = 2 if n % 2 == 0 and n > 1 else 1
    sp = n // dp
    mesh = make_mesh(n, dp=dp, sp=sp, devices=devices)
    batch, ny, nx = 2 * dp, 8 * sp, 16
    coeffs, spec, x0 = _problem(batch, ny, nx, torch.float32, dev, seed=1)
    res = sharded_solve_jacobi(coeffs, spec, x0, mesh, omega=2.0 / 3.0,
                               tol=1e-4, max_iter=200, check_every=50,
                               criterion="deff")
    deff = res.deff.cpu().numpy()
    _check(deff.shape == (batch,) and np.isfinite(deff).all(),
           f"sharded Jacobi Deff {deff}")
    lines.append(f"2D dp x sp Jacobi: mesh (dp={dp}, sp={sp}), batch "
                 f"{batch}, grid ({ny}, {nx}), Deff {deff}")

    # 3D: z-slab sharded CG over sp (halo-exchanged 7-point matvec, dots
    # summed over the slabs), the JAX twin's 3D leg
    rng = np.random.default_rng(2)
    nz, ny3, nx3 = 4 * sp, 8, 16
    d3 = torch.tensor(np.where(rng.random((nz, ny3, nx3)) < 0.6, 1.0, 1e-3),
                      dtype=torch.float32, device=dev)
    x3 = (torch.arange(nx3, dtype=torch.float32, device=dev) / nx3).expand(
        nz, ny3, nx3)
    res3 = sharded_solve_cg_3d(fvm3d.fvm_coefficients_3d(d3, 0.0, 1.0),
                               fvm3d.make_flux_spec_3d(d3, 0.0, 1.0), x3,
                               mesh, tol=1e-5, max_iter=200, check_every=50)
    d3v = float(res3.deff)
    _check(np.isfinite(d3v), f"sharded 3D CG Deff {d3v}")
    lines.append(f"3D z-slab sharded CG: grid ({nz}, {ny3}, {nx3}), Deff "
                 f"{d3v:.4f}, iterations {int(res3.iters)}")

    # the sp-sharded fused MGCG (K8/K9) against the unsharded solve; mild
    # contrast so Deff is O(1) at tol 1e-4
    ny_f = 16 * n
    rng = np.random.default_rng(3)
    d_f = torch.tensor(np.exp(rng.uniform(0, np.log(10), (ny_f, 16))),
                       dtype=torch.float32, device=dev)
    c1, s1 = fvm.fvm_coefficients(d_f, 0.0, 1.0), make_flux_spec(d_f, 0.0,
                                                                 1.0)
    x_f = (torch.arange(16, dtype=torch.float32, device=dev) / 16).expand(
        ny_f, 16)
    kw = dict(tol=1e-4, max_iter=200, check_every=10,
              criterion="relresidual", nu1=2, nu2=2)
    got = sharded_solve_mgcg(c1, s1, x_f, make_mesh(n, dp=1, sp=n,
                                                    devices=devices), **kw)
    ref = solve_mgcg(c1, s1, x_f, **kw)
    dg, dr = float(got.deff), float(ref.deff)
    _check(np.isfinite(dg) and abs(dg - dr) <= 1e-3 * abs(dr),
           f"sp-fused MGCG Deff {dg} vs unsharded {dr}")
    lines.append(f"sp-fused sharded MGCG: grid ({ny_f}, 16) on {n} shards, "
                 f"Deff {dg:.5f} vs unsharded {dr:.5f}, iterations "
                 f"{int(got.iters)} vs {int(ref.iters)}")

    # the pipeline: batch_sim on a dp mesh, Jacobi then mgcg
    imgs = [parallel_slab(16, e) for e in (0.25, 0.5, 0.75)]
    cfg = SimulationConfig(
        n_phase=2, batch_flag=True, d_fluid=1.0, d_solid=0.1,
        convergence=1e-5, max_iter=50_000, check_every=200,
        criterion="residual", solver="jacobi", num_images=len(imgs),
        incremental_output=False,
        output_name=os.path.join(out_dir, "dryrun_batch.csv"),
        devices=n, dp=n, sp=1)
    table = batch_sim(cfg, imgs=imgs, device=dev, mesh_devices=devices)
    _check(np.isfinite(table[:, 3]).all(), f"pipeline Deff {table[:, 3]}")
    lines.append(f"dp batch_sim Jacobi: devices {n}, Deff {table[:, 3]}")
    cfg_f = dataclasses.replace(
        cfg, solver="mgcg", check_every=5, max_iter=500,
        output_name=os.path.join(out_dir, "dryrun_batch_fused.csv"))
    table_f = batch_sim(cfg_f, imgs=imgs, device=dev, mesh_devices=devices)
    _check(np.isfinite(table_f[:, 3]).all()
           and np.allclose(table_f[:, 3], table[:, 3], rtol=1e-3),
           f"fused mgcg Deff {table_f[:, 3]} vs Jacobi {table[:, 3]}")
    lines.append(f"dp batch_sim mgcg: Deff {table_f[:, 3]}")
    return lines
