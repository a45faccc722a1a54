"""Slow solves of ``chip_smoke.py`` (phases 36, 39 and 43) on reduced
copies of their media, the port against the JAX package on the CPU (a
script, not a pytest module: one run takes minutes).

    JAX_PLATFORMS=cpu python tests/solver_matrix_witness.py dmg3d [n] [caps]
    JAX_PLATFORMS=cpu python tests/solver_matrix_witness.py halo3d [n] [cap]
    JAX_PLATFORMS=cpu python tests/solver_matrix_witness.py general_cycle \
        [n] [caps] [engines]

``dmg3d``: phase 36's 3-phase volume (bench3d.py's medium, sigma 3,
``default_rng(11)``, 48 gas balls, a quarter centred on each Dirichlet
face, Dg 1000, f64) at ``n``^3 (default 64) with the balls' radii scaled
by ``n / 256``, solved by ``solve_dmg_3d`` to relres 1e-10 with each cap
of ``caps`` (default 50,100,200) as its ``max_iter``: the port's (K6's
plain version) and the JAX package's (its XLA cycle).  Equal relres at
each cap says the iterations the volume needs are the algorithm's.

``halo3d``: config 5's medium (contrast 1e-6) in float32 at ``n``^3
(default 128), V(2,2), relres 1e-5, ``cap`` (default 600) iterations:
``sharded_solve_mgcg_3d`` at SP=4 in the port and in the JAX package, the
JAX package's ``solve_mgcg_3d`` (its XLA engine) and the port's (the
banded fused engine on K6/K7's plain versions).  Where both sharded
solves stop at the cap at the same relres, the float32 stall is the
z-slab algorithm's, not the port's.

``general_cycle``: config 3's medium (``default_rng(3)``, porosity 0.65,
sigma 8, contrast 1e-6) in float32 at ``n``^2 (default 512), phase 43's
settings (V(2,2), min_size 32, 64 coarse sweeps, relres 1e-4), through
the ``run_pcg`` form of ``solve_mgcg`` with each cap of ``caps`` (default
100,200,400) as its ``max_iter``, on each of ``engines`` (default
``False,True``): ``use_pallas=False`` (the plain cycle; the JAX package's
XLA cycle) and ``True`` (K2's plain version; the JAX package's Pallas
cycle in interpret mode).  Equal relres at each cap says
the residual history is the algorithm's, a float32 stall included.

Prints iterations, relres and Deff of each solve.
"""

import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from effectivediffusivityfvm_tpu.models import phases as jphases  # noqa: E402
from effectivediffusivityfvm_tpu.ops import fvm as jfvm  # noqa: E402
from effectivediffusivityfvm_tpu.ops import fvm3d as jfvm3d  # noqa: E402
from effectivediffusivityfvm_tpu.ops.flux import \
    make_flux_spec as jspec  # noqa: E402
from effectivediffusivityfvm_tpu.parallel import halo3d as jhalo3d  # noqa: E402
from effectivediffusivityfvm_tpu.parallel.mesh import make_mesh as jmesh  # noqa: E402
from effectivediffusivityfvm_tpu.solvers import dmg3d as jdmg3d  # noqa: E402
from effectivediffusivityfvm_tpu.solvers import multigrid as jmg  # noqa: E402
from effectivediffusivityfvm_tpu.solvers import solvers3d as js3  # noqa: E402
from effectivediffusivityfvm_tpu_torch.models import phases, volume  # noqa: E402
from effectivediffusivityfvm_tpu_torch.ops import fvm3d  # noqa: E402
from effectivediffusivityfvm_tpu_torch.parallel import halo3d, mesh  # noqa: E402
from effectivediffusivityfvm_tpu_torch.solvers import (  # noqa: E402
    dmg3d, multigrid, solvers3d)

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)
CPU = torch.device("cpu")


def report(tag, res, t0):
    print(f"{tag}: {int(np.asarray(res.iters))} iterations, relres "
          f"{float(np.asarray(res.conv)):.6e}, Deff "
          f"{float(np.asarray(res.deff)):.9f} ({time.time() - t0:.1f} s)",
          flush=True)


def witness_dmg3d(n, caps):
    f = n / 256
    vol = cs.gas_volume(cs.c5_fluid((n,) * 3, cs.C5_SEED), cs.C5_SEED,
                        radii=(max(2, round(6 * f)), max(3, round(20 * f))))
    classes = phases.three_phase_classes(vol)
    ff = volume.flood_fill_3d(vol > 200)
    mask = (vol > 200) | ff.isolated
    gas = (classes == phases.GAS) & ~mask
    d = phases.d_field_from_classes(classes, 1.0, 0.0, cs.DMG3D_DG,
                                    dtype=np.float64)
    x0 = np.broadcast_to(np.arange(n) / n, (n,) * 3)
    dt = torch.tensor(d)
    c = fvm3d.fvm_coefficients_3d(dt, 0.0, 1.0, mask=torch.as_tensor(mask),
                                  symmetric=True)
    s = fvm3d.make_flux_spec_3d(dt, 0.0, 1.0)
    defl = dmg3d.build_component_deflation_3d(c, gas)
    jd = jnp.asarray(jphases.d_field_from_classes(classes, 1.0, 0.0,
                                                  cs.DMG3D_DG,
                                                  dtype=np.float64))
    jc = jfvm3d.fvm_coefficients_3d(jd, 0.0, 1.0, mask=jnp.asarray(mask),
                                    symmetric=True)
    js = jfvm3d.make_flux_spec_3d(jd, 0.0, 1.0)
    jdefl = jdmg3d.build_component_deflation_3d(jc, gas)
    print(f"dmg3d {n}^3 f64, {defl.m} components", flush=True)
    kw = dict(tol=1e-10, check_every=10, criterion="relresidual")
    for cap in caps:
        t0 = time.time()
        report(f"  cap {cap} port", dmg3d.solve_dmg_3d(
            c, s, torch.tensor(x0), defl=defl, max_iter=cap, **kw), t0)
        t0 = time.time()
        report(f"  cap {cap} JAX ", jdmg3d.solve_dmg_3d(
            jc, js, jnp.asarray(x0), defl=jdefl, max_iter=cap, **kw), t0)


def witness_halo3d(n, cap):
    fluid = cs.c5_fluid((n,) * 3, cs.C5_SEED)
    d = np.where(fluid, 1.0, cs.CONTRAST).astype(np.float32)
    x0 = np.broadcast_to((np.arange(n) / n).astype(np.float32), d.shape)
    kw = dict(tol=1e-5, max_iter=cap, check_every=10,
              criterion="relresidual", nu1=2, nu2=2, mg_omega=0.8,
              coarse_iters=8, min_size=4, over=1.8)
    dt = torch.tensor(d)
    c = fvm3d.fvm_coefficients_3d(dt, 0.0, 1.0)
    s = fvm3d.make_flux_spec_3d(dt, 0.0, 1.0)
    jc = jfvm3d.fvm_coefficients_3d(jnp.asarray(d), 0.0, 1.0)
    js = jfvm3d.make_flux_spec_3d(jnp.asarray(d), 0.0, 1.0)
    print(f"halo3d {n}^3 float32", flush=True)
    t0 = time.time()
    report("  port sharded_solve_mgcg_3d SP=4", halo3d.sharded_solve_mgcg_3d(
        c, s, torch.tensor(x0), mesh.make_mesh(4, dp=1, devices=[CPU] * 4),
        **kw), t0)
    t0 = time.time()
    report("  JAX  sharded_solve_mgcg_3d SP=4", jhalo3d.sharded_solve_mgcg_3d(
        jc, js, jnp.asarray(x0), jmesh(4, dp=1), **kw), t0)
    t0 = time.time()
    report("  JAX  solve_mgcg_3d (XLA)", js3.solve_mgcg_3d(
        jc, js, jnp.asarray(x0), **kw), t0)
    t0 = time.time()
    report("  port solve_mgcg_3d (banded fused)", solvers3d.solve_mgcg_3d(
        c, s, torch.tensor(x0), **kw), t0)


def witness_general_cycle(n, caps, engines):
    img = cs.correlated_binary(np.random.default_rng(cs.C3_SEED), n, n)
    _, c, s, x0 = cs.c3_problem(img, CPU)
    d = np.where(img == 0, 1.0, cs.CONTRAST).astype(np.float32)
    jc = jfvm.fvm_coefficients(jnp.asarray(d), 0.0, 1.0)
    js = jspec(jnp.asarray(d), 0.0, 1.0)
    jx0 = jnp.asarray(x0.numpy())
    print(f"general_cycle {n}^2 float32", flush=True)
    for cap in caps:
        kw = dict(cs.C3_KW, max_iter=cap)
        for engine in engines:
            t0 = time.time()
            report(f"  cap {cap} use_pallas={engine} port", multigrid.solve_mgcg(
                c, s, x0, use_pallas=engine, **kw), t0)
            t0 = time.time()
            report(f"  cap {cap} use_pallas={engine} JAX ", jmg.solve_mgcg(
                jc, js, jx0, use_pallas=engine, pallas_interpret=engine,
                **kw), t0)


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "dmg3d":
        witness_dmg3d(int(sys.argv[2]) if len(sys.argv) > 2 else 64,
                      [int(v) for v in (sys.argv[3] if len(sys.argv) > 3
                                        else "50,100,200").split(",")])
    elif what == "halo3d":
        witness_halo3d(int(sys.argv[2]) if len(sys.argv) > 2 else 128,
                       int(sys.argv[3]) if len(sys.argv) > 3 else 600)
    elif what == "general_cycle":
        witness_general_cycle(
            int(sys.argv[2]) if len(sys.argv) > 2 else 512,
            [int(v) for v in (sys.argv[3] if len(sys.argv) > 3
                              else "100,200,400").split(",")],
            [v == "True" for v in (sys.argv[4] if len(sys.argv) > 4
                                   else "False,True").split(",")])
    else:
        sys.exit(f"unknown witness {what!r}: dmg3d, halo3d or "
                 "general_cycle")
