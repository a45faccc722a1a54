"""The port's z-slab sharded 3D solvers (``parallel/halo3d.py``) against the
JAX package's ``parallel/halo3d.py`` on the CPU, in float64: Jacobi,
diagonal-PCG and MGCG (its gathered tail on K6's plain version against
the JAX XLA cycle) on one volume over ``sp`` and a batch over ``dp x
sp``; the slab-local hierarchy; the dry-run twin's 3D leg against the JAX
one; the cycles that raise.

The port's mesh is a list of CPU entries; the JAX side runs ``shard_map``
on the virtual CPU devices of ``tests/conftest.py``.  The media have a
contrast of 10 and the MGCG runs 4 coarse sweeps, which keeps the JAX
compile short.  Tolerances: identical iterations; Deff rtol 1e-12 for
Jacobi and CG, 1e-9 for MGCG (its K6 tail rebuilds the diagonal as
1/diag_inv); the hierarchy rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import fvm3d as jfvm3d
from effectivediffusivityfvm_tpu.parallel import halo3d as jhalo3d
from effectivediffusivityfvm_tpu.parallel.mesh import make_mesh as jmake_mesh
from effectivediffusivityfvm_tpu_torch.ops import fvm3d
from effectivediffusivityfvm_tpu_torch.parallel import halo, halo3d, mesh
from effectivediffusivityfvm_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _systems(d):
    nx = d.shape[-1]
    x0 = np.broadcast_to(np.arange(nx) / nx, d.shape).copy()
    dt = torch.tensor(d)
    port = (fvm3d.fvm_coefficients_3d(dt, 0.0, 1.0),
            fvm3d.make_flux_spec_3d(dt, 0.0, 1.0), torch.tensor(x0))
    dj = jnp.asarray(d)
    if d.ndim == 4:
        jc = jax.vmap(lambda a: jfvm3d.fvm_coefficients_3d(a, 0.0, 1.0))(dj)
        js = jax.vmap(lambda a: jfvm3d.make_flux_spec_3d(a, 0.0, 1.0))(dj)
    else:
        jc = jfvm3d.fvm_coefficients_3d(dj, 0.0, 1.0)
        js = jfvm3d.make_flux_spec_3d(dj, 0.0, 1.0)
    return port, (jc, js, jnp.asarray(x0))


def _medium(seed, shape, contrast=10.0):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(0, np.log(contrast), shape))


LAYOUTS = {
    # one volume on four slabs: the MGCG tail gathers (12, 12, 12) and
    # runs three levels of K6
    "sp4": ((24, 12, 12), 4, 1),
    # a batch over dp x sp
    "dp2_sp2": ((2, 8, 8, 8), 4, 2),
}
SOLVERS = {
    "jacobi": (dict(omega=2.0 / 3.0, tol=1e-6, max_iter=20_000,
                    check_every=50, criterion="residual"), 1e-12),
    "cg": (dict(tol=1e-9, max_iter=400, check_every=10,
                criterion="residual"), 1e-12),
    "mgcg": (dict(tol=1e-9, max_iter=200, check_every=10,
                  criterion="relresidual", nu1=2, nu2=2, coarse_iters=4),
             1e-9),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_3d_solvers_match_jax(layout, solver):
    shape, n, dp = LAYOUTS[layout]
    (c, s, x0), (jc, js, jx0) = _systems(_medium(1, shape))
    kw, rtol = SOLVERS[solver]
    fn = f"sharded_solve_{solver}_3d"
    got = getattr(halo3d, fn)(c, s, x0, mesh.make_mesh(n, dp=dp,
                                                       devices=[CPU] * n),
                              **kw)
    ref = getattr(jhalo3d, fn)(jc, js, jx0, jmake_mesh(n, dp=dp), **kw)
    np.testing.assert_array_equal(np.atleast_1d(got.iters.numpy()),
                                  np.atleast_1d(np.asarray(ref.iters)))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=rtol)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-8,
                               atol=1e-10)
    assert tuple(got.x.shape) == shape


def test_slab_hierarchy_matches_jax():
    """The slab-local levels equal the JAX package's ``_coarsen_local`` on
    every shard (gathered back along z)."""
    (c, s, x0), (jc, js, jx0) = _systems(_medium(2, (16, 8, 8), 1e3))
    pm = mesh.make_mesh(4, dp=1, devices=[CPU] * 4)
    batched, c_rows, _, _ = halo._place(pm, c, s, x0, 3)
    got = halo3d._coarsen_local(c_rows[0])

    jm = jmake_mesh(4, dp=1)
    spec3 = jax.sharding.PartitionSpec("sp", None, None)

    @jax.jit
    def coarsen(cj):
        return jax.shard_map(
            lambda cl: jhalo3d._coarsen_local(cl, "sp"), mesh=jm,
            in_specs=(type(cj)(*([spec3] * 9)),),
            out_specs=type(cj)(*([spec3] * 9)), check_vma=False)(cj)

    want = coarsen(jc)
    for f, w in zip(fvm3d.StencilCoeffs3D._fields, want):
        g = torch.cat([getattr(sh, f)[0] for sh in got], dim=-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-14, err_msg=f)


def test_mgcg_3d_matches_the_unsharded_engine():
    """Sharded MGCG (run_pcg, checks every 10) against the unsharded fused
    engine (K7): the same solution to the tolerance."""
    from effectivediffusivityfvm_tpu_torch.solvers.solvers3d import \
        solve_mgcg_3d

    (c, s, x0), _ = _systems(_medium(3, (16, 16, 16), 1e2))
    kw = dict(tol=1e-10, max_iter=200, check_every=10,
              criterion="relresidual", nu1=2, nu2=2)
    got = halo3d.sharded_solve_mgcg_3d(
        c, s, x0, mesh.make_mesh(2, dp=1, devices=[CPU] * 2), **kw)
    ref = solve_mgcg_3d(c, s, x0, **kw)
    assert abs(int(got.iters) - int(ref.iters)) <= 10
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-8)


def test_unequal_and_deep_cycles_raise():
    """V(1, 2) and V(4, 4), refused before the plain ``v_cycle_3d`` was
    ported, run it on the gathered tail and equal the unsharded solve (on
    the plain engine too); V(0, 0) and an SP that does not divide nz
    raise."""
    from effectivediffusivityfvm_tpu_torch.solvers.solvers3d import \
        solve_mgcg_3d

    (c, s, x0), _ = _systems(_medium(4, (8, 8, 8)))
    pm = mesh.make_mesh(2, dp=1, devices=[CPU] * 2)
    kw = dict(tol=1e-9, max_iter=200, check_every=10,
              criterion="relresidual", coarse_iters=4)
    for nu1, nu2 in ((1, 2), (4, 4)):
        got = halo3d.sharded_solve_mgcg_3d(c, s, x0, pm, nu1=nu1, nu2=nu2,
                                           **kw)
        ref = solve_mgcg_3d(c, s, x0, nu1=nu1, nu2=nu2, **kw)
        assert int(got.iters) == int(ref.iters)
        np.testing.assert_allclose(float(got.deff), float(ref.deff),
                                   rtol=1e-9)
    with pytest.raises(ValueError, match="nu1 >= 1"):
        halo3d.sharded_solve_mgcg_3d(c, s, x0, pm, nu1=0, nu2=0)
    with pytest.raises(ValueError, match="divide"):
        halo3d.sharded_solve_cg_3d(
            c, s, x0, mesh.make_mesh(3, dp=1, devices=[CPU] * 3))


def test_dryrun_3d_leg_matches_jax(tmp_path):
    lines = dryrun_multichip([CPU] * 8, device="cpu", out_dir=str(tmp_path))
    leg = lines[1]
    # the JAX twin's 3D leg (__graft_entry__.dryrun_multichip) on the
    # (dp=2, sp=4) mesh, float32
    rng = np.random.default_rng(2)
    d3 = jnp.asarray(np.where(rng.random((16, 8, 16)) < 0.6, 1.0, 1e-3),
                     jnp.float32)
    x3 = jnp.broadcast_to(jnp.arange(16, dtype=jnp.float32) / 16,
                          (16, 8, 16))
    ref = jhalo3d.sharded_solve_cg_3d(
        jfvm3d.fvm_coefficients_3d(d3, 0.0, 1.0),
        jfvm3d.make_flux_spec_3d(d3, 0.0, 1.0), x3, jmake_mesh(8, dp=2),
        tol=1e-5, max_iter=200, check_every=50)
    assert f"iterations {int(ref.iters)}" in leg
    assert f"Deff {float(ref.deff):.4f}" in leg
