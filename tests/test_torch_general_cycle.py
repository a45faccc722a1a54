"""The port's general-cycle MGCG engines against the JAX package's on the
CPU, in float64:

  * the plain torch cycles ``multigrid.v_cycle`` and
    ``solvers3d.v_cycle_3d`` against the JAX XLA ``v_cycle``/``v_cycle_3d``
    on the same hierarchy (odd dims, V(1,1), V(2,1), a tuple ``omega``);
  * ``solve_mgcg*`` with ``use_pallas=False`` and auto V(2,1) against the
    JAX package's default engine on the CPU (its XLA cycle under
    ``run_pcg``), a batch with one image that stops early; the cycle-only
    kernel engines (``True``: K2, ``"tiledcycle"``: K4) on their plain
    versions against the JAX Pallas cycles in interpret mode;
  * ``solve_mgcg_3d`` with ``use_pallas=False`` and auto V(2,1);
  * ``solve_dmg`` on the plain cycle (forced, and auto at nu = 9) and
    ``solve_dmg_3d`` at nu = 4;
  * ``sharded_solve_mgcg`` at V(2,1) and ``sharded_solve_mgcg_3d`` at
    V(4,4) against the JAX ones on their virtual devices;
  * ``batch_sim`` with ``Pallas: off`` and ``Pallas: interpret``, and
    ``deff_and_grad`` on the plain engine.

Tolerances: the cycles rtol 1e-12 of max|e| (the same operations in the
same order); the ``run_pcg`` solves identical iterations and Deff rtol
1e-10 (dot products summed in another order than XLA's), 1e-9 where the
JAX side runs a Pallas kernel in interpret mode or the dots are summed per
shard, 1e-8 for ``dmg``'s float32 cycles; the gradient rtol 1e-8 of
max|g|.  The
sizes are small and the coarse solves short, which keeps the JAX compiles
to seconds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu import config as jconfig
from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.autodiff import \
    deff_and_grad as j_deff_and_grad
from effectivediffusivityfvm_tpu.parallel import halo as jhalo
from effectivediffusivityfvm_tpu.parallel import halo3d as jhalo3d
from effectivediffusivityfvm_tpu.parallel.mesh import make_mesh as jmake_mesh
from effectivediffusivityfvm_tpu.pipeline import batch as jbatch
from effectivediffusivityfvm_tpu.solvers import dmg as jdmg
from effectivediffusivityfvm_tpu.solvers import dmg3d as jdmg3d
from effectivediffusivityfvm_tpu.solvers import multigrid as jmg
from effectivediffusivityfvm_tpu.solvers import solvers3d as js3
from effectivediffusivityfvm_tpu_torch import config
from effectivediffusivityfvm_tpu_torch.ops import fvm, fvm3d
from effectivediffusivityfvm_tpu_torch.ops.autodiff import deff_and_grad
from effectivediffusivityfvm_tpu_torch.parallel import halo, halo3d, mesh
from effectivediffusivityfvm_tpu_torch.pipeline import batch
from effectivediffusivityfvm_tpu_torch.solvers import (dmg, dmg3d, multigrid,
                                                       solvers3d)

import test_torch_dmg3d as t_dmg3d
import test_torch_halo3d as t_halo3d
from test_torch_deflation import _blob_image, _system, _to_jax
from test_torch_pipeline import _img2, _recorder
from test_torch_sharded import _cpu_mesh, _medium, _systems

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
SOLVE = dict(tol=1e-10, max_iter=300, check_every=10,
             criterion="relresidual", coarse_iters=8, min_size=4)


def _allclose(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _check(got, ref, rtol):
    np.testing.assert_array_equal(np.atleast_1d(got.iters.numpy()),
                                  np.atleast_1d(np.asarray(ref.iters)))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=rtol)
    assert np.all(got.conv.numpy() <= SOLVE["tol"])


# ------------------------------------------------------------ the cycles

CYCLES = {"V11": dict(nu1=1, nu2=1), "V21": dict(nu1=2, nu2=1),
          "tuple_omega": dict(nu1=2, nu2=2, omega=(1.281, 0.5584))}


def _jax_levels(levels, ctor):
    return [ctor(*(jnp.asarray(a.numpy()) for a in lvl)) for lvl in levels]


@pytest.mark.parametrize("case", list(CYCLES))
def test_v_cycle_matches_jax(case):
    """On the unpadded hierarchy of a (17, 15) batch: levels (17, 15),
    (9, 8), (5, 4), so both odd paddings of the correction equation run."""
    kw = dict(CYCLES[case], coarse_iters=8, over=1.8)
    d = _medium(3, (2, 17, 15))
    c = _systems(d)[0][0]
    lv = multigrid.build_hierarchy(c, min_size=4)
    assert [tuple(a.diag.shape[-2:]) for a in lv] == [(17, 15), (9, 8),
                                                      (5, 4)]
    r = np.random.default_rng(4).standard_normal((2, 17, 15))
    want = jax.jit(functools.partial(jmg.v_cycle, **kw))(
        _jax_levels(lv, jfvm.StencilCoeffs), jnp.asarray(r))
    got = multigrid.v_cycle(lv, torch.tensor(r), **kw)
    _allclose(got.numpy(), want, 1e-12)


@pytest.mark.parametrize("case", ["V11", "V21"])
def test_v_cycle_3d_matches_jax(case):
    kw = dict(CYCLES[case], coarse_iters=8, over=1.8)
    d = torch.tensor(_medium(5, (2, 9, 10, 7)))
    lv = solvers3d.build_hierarchy_3d(
        fvm3d.fvm_coefficients_3d(d, 0.0, 1.0), min_size=2)
    assert len(lv) == 3
    r = np.random.default_rng(6).standard_normal((2, 9, 10, 7))
    want = jax.jit(functools.partial(js3.v_cycle_3d, **kw))(
        _jax_levels(lv, js3.StencilCoeffs3D), jnp.asarray(r))
    got = solvers3d.v_cycle_3d(lv, torch.tensor(r), **kw)
    _allclose(got.numpy(), want, 1e-12)


# ------------------------------------------------------------ 2D solves

@pytest.fixture(scope="module")
def batch2d():
    """Three (17, 15) images; the third (contrast 2) stops well before the
    others, so the batched loop freezes it.  The JAX reference is its
    default engine on the CPU at V(2, 1): the XLA cycle under run_pcg."""
    d = np.stack([_medium(5, (17, 15)), _medium(6, (17, 15)),
                  _medium(7, (17, 15), 2.0)])
    port, jsys = _systems(d)
    ref = jmg.solve_mgcg_batched(*jsys, nu1=2, nu2=1, **SOLVE)
    assert int(ref.iters[2]) < int(ref.iters[0])
    return port, jsys, ref


@pytest.mark.parametrize("use_pallas", [False, None])
def test_solve_mgcg_batched_plain_engine_matches_jax(batch2d, use_pallas):
    """``use_pallas=False`` and auto (which takes ``False`` for V(2,1))."""
    port, _, ref = batch2d
    assert multigrid._engine_auto(17, 15, F64, 2, 1) is False
    got = multigrid.solve_mgcg_batched(*port, nu1=2, nu2=1,
                                       use_pallas=use_pallas, **SOLVE)
    _check(got, ref, 1e-10)


def test_solve_mgcg_plain_engine_matches_jax():
    (c, s, x0), jsys = _systems(_medium(8, (17, 15)))
    ref = jmg.solve_mgcg(*jsys, nu1=2, nu2=2, **SOLVE)
    got = multigrid.solve_mgcg(c, s, x0, nu1=2, nu2=2, use_pallas=False,
                               **SOLVE)
    _check(got, ref, 1e-10)


@pytest.mark.parametrize("use_pallas", [True, "tiledcycle"])
def test_cycle_only_kernel_engines_match_jax(batch2d, use_pallas):
    port, jsys, _ = batch2d
    ref = jmg.solve_mgcg_batched(*jsys, nu1=2, nu2=2, use_pallas=use_pallas,
                                 pallas_interpret=True, **SOLVE)
    got = multigrid.solve_mgcg_batched(*port, nu1=2, nu2=2,
                                       use_pallas=use_pallas, **SOLVE)
    _check(got, ref, 1e-9)


@pytest.mark.parametrize("use_pallas", [True, "tiledcycle"])
def test_cycle_only_kernel_engines_run_nu1_cycles(batch2d, use_pallas):
    """Given V(2, 1), the cycle-only kernel engines run V(2, 2), as the JAX
    ones do (they take ``nu1`` alone)."""
    port, jsys, _ = batch2d
    ref = jmg.solve_mgcg_batched(*jsys, nu1=2, nu2=1, use_pallas=use_pallas,
                                 pallas_interpret=True, **SOLVE)
    got = multigrid.solve_mgcg_batched(*port, nu1=2, nu2=1,
                                       use_pallas=use_pallas, **SOLVE)
    _check(got, ref, 1e-9)
    same = multigrid.solve_mgcg_batched(*port, nu1=2, nu2=2,
                                        use_pallas=use_pallas, **SOLVE)
    assert torch.equal(got.iters, same.iters)
    assert torch.equal(got.deff, same.deff)


# ------------------------------------------------------------ 3D solves

@pytest.mark.parametrize("case", ["plain_V22", "auto_V21"])
def test_solve_mgcg_3d_plain_engine_matches_jax(case):
    """One (9, 10, 8) volume forced onto the plain engine, and a batch of
    two whose V(2,1) auto sends to it (on the CPU the JAX auto does too)."""
    kw = dict(SOLVE, min_size=2)
    shape = (9, 10, 8) if case == "plain_V22" else (2, 9, 10, 8)
    (c, s, x0), jsys = t_halo3d._systems(t_halo3d._medium(9, shape, 1e3))
    if case == "plain_V22":
        ref = js3.solve_mgcg_3d(*jsys, nu1=2, nu2=2, use_pallas=False, **kw)
        got = solvers3d.solve_mgcg_3d(c, s, x0, nu1=2, nu2=2,
                                      use_pallas=False, **kw)
    else:
        assert solvers3d._engine_auto_3d(2, 1) is False
        ref = js3.solve_mgcg_3d_batched(*jsys, nu1=2, nu2=1, **kw)
        got = solvers3d.solve_mgcg_3d_batched(c, s, x0, nu1=2, nu2=1, **kw)
    _check(got, ref, 1e-10)


# ------------------------------------------------------------ dmg

@pytest.mark.parametrize("case", ["plain_nu2", "auto_nu9"])
def test_solve_dmg_plain_cycle_matches_jax(case):
    """``use_pallas=False`` at nu = 2, and nu = 9, past K2's, which the
    auto rule sends to the plain cycle (the JAX auto takes its XLA cycle
    on the CPU at every nu)."""
    c, s, x0, gas = _system(_blob_image(1, n=16, blobs=2))
    kw = dict(tol=1e-10, max_iter=300, coarse_iters=4, min_size=8)
    if case == "plain_nu2":
        kw.update(nu=2, use_pallas=False)
    else:
        kw.update(nu=9)
        assert dmg._dmg_engine_auto((16, 16), torch.float32, 9) is False
    ref = jdmg.solve_dmg(_to_jax(c), _to_jax(s), jnp.asarray(x0.numpy()),
                         member=gas, **kw)
    got = dmg.solve_dmg(c, s, x0, member=gas, **kw)
    assert float(got.conv) <= 1e-10 and float(ref.conv) <= 1e-10
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-8)


def test_solve_dmg_3d_nu4_matches_jax():
    """nu = 4, past K6's: the auto rule takes the plain ``v_cycle_3d``,
    the JAX package's own cycle here."""
    (c, s, x0), jsys, gas = t_dmg3d._system(t_dmg3d.gas_volume(2, n=8))
    kw = dict(tol=1e-10, max_iter=300, nu=4, coarse_iters=4, min_size=2)
    assert dmg3d._dmg3d_engine_auto((8,) * 3, torch.float32, 4) is False
    ref = jdmg3d.solve_dmg_3d(*jsys, member=gas, **kw)
    got = dmg3d.solve_dmg_3d(c, s, x0, member=gas, **kw)
    assert float(got.conv) <= 1e-10 and float(ref.conv) <= 1e-10
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-8)


# ------------------------------------------------------------ sharded

def test_sharded_mgcg_unequal_cycle_matches_jax():
    """V(2,1) on four 8-row shards: the run_pcg route, one sharded level,
    then the plain cycle on the gathered tail (the JAX XLA route)."""
    d = _medium(12, (32, 16), 1e1)
    (c, s, x0), jsys = _systems(d)
    kw = dict(tol=1e-9, max_iter=400, check_every=10,
              criterion="relresidual", coarse_iters=4, nu1=2, nu2=1)
    ref = jhalo.sharded_solve_mgcg(*jsys, jmake_mesh(4, dp=1), **kw)
    got = halo.sharded_solve_mgcg(c, s, x0, _cpu_mesh(4), **kw)
    np.testing.assert_array_equal(int(got.iters), int(ref.iters))
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-9)
    assert float(got.conv) <= 1e-9


def test_sharded_mgcg_plain_tail_hierarchy_matches_jax():
    """V(2,1) on four 8-row shards of a (32, 17) image with min_size 9:
    the odd columns stop any shard-local level, and the gathered tail's
    unpadded hierarchy (the JAX package's) has two levels where the one
    padded for K2 would have three."""
    d = _medium(13, (32, 17), 1e1)
    (c, s, x0), jsys = _systems(d)
    kw = dict(tol=1e-9, max_iter=400, check_every=10,
              criterion="relresidual", coarse_iters=4, nu1=2, nu2=1,
              min_size=9)
    row = [fvm.StencilCoeffs(*(a[8 * i:8 * (i + 1)] for a in c))
           for i in range(4)]
    for pad, n_levels in ((False, 2), (True, 3)):
        hier = halo._build_sharded_hierarchy_2d(row, 8, min_size=9,
                                                pad_levels=pad)
        assert not hier.sharded and len(hier.replicated[0]) == n_levels
    ref = jhalo.sharded_solve_mgcg(*jsys, jmake_mesh(4, dp=1), **kw)
    got = halo.sharded_solve_mgcg(c, s, x0, _cpu_mesh(4), **kw)
    np.testing.assert_array_equal(int(got.iters), int(ref.iters))
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-9)
    assert float(got.conv) <= 1e-9


def test_sharded_mgcg_3d_nu4_matches_jax():
    """V(4,4), past K6's: the z-slab tail runs the plain ``v_cycle_3d``
    (four 4-plane slabs, one slab-local level, a tail of two levels)."""
    (c, s, x0), jsys = t_halo3d._systems(t_halo3d._medium(1, (16, 8, 8)))
    kw = dict(tol=1e-9, max_iter=200, check_every=10,
              criterion="relresidual", nu1=4, nu2=4, coarse_iters=4,
              min_size=2)
    ref = jhalo3d.sharded_solve_mgcg_3d(*jsys, jmake_mesh(4, dp=1), **kw)
    got = halo3d.sharded_solve_mgcg_3d(
        c, s, x0, mesh.make_mesh(4, dp=1, devices=[CPU] * 4), **kw)
    np.testing.assert_array_equal(int(got.iters), int(ref.iters))
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-9)
    assert float(got.conv) <= 1e-9


# ------------------------------------------------------------ pipeline

@pytest.mark.parametrize("pallas", ["off", "interpret"])
def test_batch_sim_pallas_modes_match_jax(tmp_path, monkeypatch, pallas):
    """``Pallas: off`` is the plain engine on both sides; ``interpret`` is
    K1/K2 in JAX's interpreter against the port's plain versions.  Both
    pipelines' solver calls get 4 coarse sweeps (a test-side wrapper of
    their ``solve_batched``): the JAX XLA cycle's compile grows with the
    sweeps it unrolls."""
    imgs = [_img2(1, 16), _img2(2, 16)]
    runs = []
    for mod, pipe, kw in ((jconfig, jbatch, {}),
                          (config, batch, {"device": "cpu"})):
        monkeypatch.setattr(pipe, "solve_batched", functools.partial(
            pipe.solve_batched, coarse_iters=4))
        cfg = mod.SimulationConfig(
            n_phase=2, d_fluid=1.0, d_solid=1e-2, convergence=1e-9,
            max_iter=2000, check_every=10, dtype="float64",
            criterion="relresidual", solver="mgcg", pallas=pallas,
            batch_flag=True, num_images=2,
            output_name=str(tmp_path / f"{mod.__name__}.csv"))
        log = []
        monkeypatch.setattr(pipe, "solve_image_group",
                            _recorder(pipe, "solve_image_group", log))
        runs.append((pipe.batch_sim(cfg, imgs=imgs, **kw),
                     np.concatenate(log)))
    (ref, ref_it), (got, it) = runs
    np.testing.assert_array_equal(it, ref_it)
    # columns: index, porosity, PathFlag, Deff, Time, cells, conv, ...
    np.testing.assert_allclose(got[:, 3], ref[:, 3], rtol=1e-9)
    assert np.all(got[:, 6] <= 1e-9)


def test_deff_and_grad_plain_engine_matches_jax():
    d = _medium(3, (12, 12), 1e2)
    skw = dict(use_pallas=False, nu1=2, nu2=1, coarse_iters=4, min_size=4)
    j_value, j_grad = j_deff_and_grad(jnp.asarray(d), solver_kw=skw)
    value, grad = deff_and_grad(torch.tensor(d), solver_kw=skw)
    np.testing.assert_allclose(float(value), float(j_value), rtol=1e-10)
    _allclose(grad.numpy(), j_grad, 1e-8)
