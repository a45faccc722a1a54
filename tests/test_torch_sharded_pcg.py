"""The row-sharded MGCG modes under ``run_pcg`` (``parallel/sharded_pcg.py``)
against the JAX package's ``sharded_solve_mgcg`` on the CPU, in float64:

  * route (a), the cycle-only engine the JAX package takes when a local
    block fails ``sharded_fused_cg_ok`` (odd rows, fewer than 8 rows)
    (JAX: its fused cycle in interpret mode);
  * route (b), ``use_pallas=False`` and V(nu, nu) with ``nu > 4`` (JAX:
    its XLA cycle);

both on the port's plain sharded cycle with the gathered K2 tail (K8's
band needs the block the fused engine needs, so it has no level here);

then the port alone: the routes' cycles, the pipeline's ``SP`` route on a
block of odd rows, and the cycles that still raise.

The port's mesh is a list of CPU entries; the JAX side runs ``shard_map``
on the virtual CPU devices of ``tests/conftest.py``.  The media have the
moderate contrast of ``tests/test_torch_sharded.py::_medium`` (1e1), so
the rebuilt coarse diagonal of the port's K2 tail (ROADMAP Queue 3) does
not part it from the JAX XLA tail; 4 coarse sweeps keep the JAX compile
short.  Tolerances: identical iterations, Deff rtol 1e-9.
"""

import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.parallel import halo as jhalo
from effectivediffusivityfvm_tpu.parallel.mesh import make_mesh as jmake_mesh
from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
from effectivediffusivityfvm_tpu_torch.parallel import fused2d, halo, mesh
from effectivediffusivityfvm_tpu_torch.pipeline.batch import batch_sim

from test_torch_sharded import _cpu_mesh, _medium, _systems

torch.set_num_threads(1)
CPU = torch.device("cpu")
KW = dict(tol=1e-7, max_iter=400, check_every=10, criterion="relresidual",
          coarse_iters=4)


def _both(d, n, dp, port_kw, jax_kw):
    (c, s, x0), (jc, js, jx0) = _systems(d)
    got = halo.sharded_solve_mgcg(c, s, x0, _cpu_mesh(n, dp=dp),
                                  **KW, **port_kw)
    ref = jhalo.sharded_solve_mgcg(jc, js, jx0, jmake_mesh(n, dp=dp),
                                   **KW, **jax_kw)
    return got, ref


def _check(got, ref, shape):
    np.testing.assert_array_equal(np.atleast_1d(got.iters.numpy()),
                                  np.atleast_1d(np.asarray(ref.iters)))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=1e-9)
    assert np.all(got.conv.numpy() <= KW["tol"])
    assert tuple(got.x.shape) == shape


ROUTE_A = {
    # 9-row shards: no sharded level, K2 on the gathered image
    "odd_rows": ((36, 16), 4, 1),
    # 4-row shards: one sharded level on the plain sweeps, then K2
    "four_rows": ((32, 16), 8, 1),
    # a batch over dp x sp, 9-row shards
    "dp2_sp2": ((2, 18, 16), 4, 2),
}


@pytest.mark.parametrize("case", list(ROUTE_A))
def test_route_a_matches_jax(case):
    shape, n, dp = ROUTE_A[case]
    d = (_medium(12, shape, 1e1) if len(shape) == 2 else
         np.stack([_medium(7, shape[1:], 1e1), _medium(8, shape[1:], 3.0)]))
    got, ref = _both(d, n, dp, dict(nu1=2, nu2=2),
                     dict(nu1=2, nu2=2, use_pallas=True,
                          pallas_interpret=True))
    _check(got, ref, shape)


@pytest.mark.parametrize("nu, use_pallas", [(2, False), (5, None),
                                            (5, False)])
def test_route_b_matches_jax(nu, use_pallas):
    d = _medium(12, (32, 16), 1e1)
    got, ref = _both(d, 4, 1, dict(nu1=nu, nu2=nu, use_pallas=use_pallas),
                     dict(nu1=nu, nu2=nu, use_pallas=False))
    _check(got, ref, (32, 16))


def _spy(monkeypatch, module, name, seen):
    fn = getattr(module, name)

    def run(*a, **kw):
        seen.append(name)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, run)


@pytest.mark.parametrize("shape, n, use_pallas", [
    ((36, 16), 4, None),
    ((32, 16), 4, False),
])
def test_routes_run_their_cycle_with_the_k2_tail(monkeypatch, shape, n,
                                                 use_pallas):
    from effectivediffusivityfvm_tpu_torch.parallel import sharded_pcg

    seen = []
    cycle = "_v_cycle_sharded_2d"
    _spy(monkeypatch, sharded_pcg, cycle, seen)
    for mod in (fused2d, halo):
        _spy(monkeypatch, mod, "gathered_cycle", seen)
    _spy(monkeypatch, fused2d, "shard_row_t1", seen)
    (c, s, x0), _ = _systems(_medium(3, shape, 1e1))
    res = halo.sharded_solve_mgcg(c, s, x0, _cpu_mesh(n), nu1=2, nu2=2,
                                  use_pallas=use_pallas, **KW)
    assert float(res.conv) <= KW["tol"]
    assert cycle in seen and "gathered_cycle" in seen
    assert "shard_row_t1" not in seen       # no block here has K8's band


def test_batch_sp_route_on_odd_shards(tmp_path):
    """``SP: 4`` on 36-row images (9-row shards) takes route (a); its rows
    agree with the one-device batch to the solve's tolerance."""
    rng = np.random.default_rng(5)
    imgs = [((rng.random((36, 24)) < 0.3) * 255).astype(np.uint8)
            for _ in range(2)]

    def run(name, **kw):
        cfg = SimulationConfig(
            n_phase=2, batch_flag=True, d_fluid=1.0, d_solid=0.1,
            convergence=1e-9, max_iter=2000, check_every=10,
            dtype="float64", criterion="residual", solver="mgcg",
            output_name=str(tmp_path / name), num_images=2,
            incremental_output=False, **kw)
        return batch_sim(cfg, imgs=imgs, device="cpu",
                         mesh_devices=[CPU] * 4)

    one = run("a.csv")
    sharded = run("b.csv", devices=4, dp=1, sp=4)
    np.testing.assert_allclose(sharded[:, 3], one[:, 3], rtol=1e-6)
    assert np.all(sharded[:, 6] <= 1e-9)


def test_unequal_and_deep_cycles_raise():
    """V(1, 2) and V(9, 9), refused before the plain cycle was ported, run
    under run_pcg with it on the gathered tail and equal the unsharded solve
    (the plain engine there too; against the JAX package:
    tests/test_torch_general_cycle.py); V(0, 0) and an unknown engine
    raise."""
    from effectivediffusivityfvm_tpu_torch.solvers.multigrid import solve_mgcg

    (c, s, x0), _ = _systems(_medium(12, (32, 16), 1e1))
    pm = _cpu_mesh(4)
    for nu1, nu2 in ((1, 2), (9, 9)):
        got = halo.sharded_solve_mgcg(c, s, x0, pm, nu1=nu1, nu2=nu2, **KW)
        ref = solve_mgcg(c, s, x0, nu1=nu1, nu2=nu2, use_pallas=False, **KW)
        assert int(got.iters) == int(ref.iters)
        np.testing.assert_allclose(float(got.deff), float(ref.deff),
                                   rtol=1e-9)
    with pytest.raises(ValueError, match="nu1 >= 1"):
        halo.sharded_solve_mgcg(c, s, x0, pm, nu1=0, nu2=0)
    with pytest.raises(ValueError, match="use_pallas"):
        halo.sharded_solve_mgcg(c, s, x0, pm, use_pallas="tiled")


def test_sharded_field_algebra():
    rows = [[torch.full((2, 3, 4), 1.0 + d + s) for s in range(2)]
            for d in range(2)]
    f = mesh.ShardedField(rows, (4, 6, 4), torch.float64, CPU)
    a = torch.arange(4.0, dtype=torch.float64).reshape(4, 1, 1)
    g = f + a * f - f
    assert [float(t[1, 0, 0]) for row in g.shards for t in row] == \
        [1.0, 2.0, 6.0, 9.0]
    w = torch.where((a > 1.5), g, f)
    # row 0 (images 0, 1) keeps f, row 1 (images 2, 3) takes g = a f
    assert [float(t[:, 0, 0].sum()) for row in w.shards for t in row] == \
        [2.0, 4.0, 2 * 2.0 + 3 * 2.0, 2 * 3.0 + 3 * 3.0]
