"""The port's 3D voxel path against the JAX package's, on the CPU, in
float64: assembly and flux, the hierarchy, flood fill, K6 (the 3D V-cycles)
and K7 (the three-pass CG steps) through their plain versions against the
JAX kernels in interpret mode, the banded fused solve against the JAX
engine (``use_pallas="tiled3d", pallas_interpret=True``), and the
pipelines and the ``.npy`` CLI routes on tiny volumes.

Both sides get the identical system: the JAX package's operators and
hierarchies reach the port through ``convert``.  Tolerances: assembly and
the hierarchy are a few elementwise ops (rtol 1e-12); the cycles are fixed
sequences of stencil passes (atol 1e-12 max|z|); the CG steps add volume
dot products whose summation order differs between XLA and torch,
amplified over k=3 iterations (rtol 1e-10); the solves compare Deff at
rtol 1e-9 with identical iteration counts.  The JAX XLA 3D engine is never
called (its compile takes over a minute here); each JAX reference is
computed once per module.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.models import volume as jvolume
from effectivediffusivityfvm_tpu.ops import fvm3d as jfvm3d
from effectivediffusivityfvm_tpu.ops.kernels import vcycle3d as jv3
from effectivediffusivityfvm_tpu.ops.kernels.cgstep3d import \
    cg_steps3d_tiled as j_cg_steps3d
from effectivediffusivityfvm_tpu.solvers import solvers3d as js3
from effectivediffusivityfvm_tpu_torch import cli, convert
from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
from effectivediffusivityfvm_tpu_torch.models import volume as tvolume
from effectivediffusivityfvm_tpu_torch.ops import fvm3d as tfvm3d
from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle3d as tv3
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep3d import (
    cg_steps3d, cg_steps3d_reference)
from effectivediffusivityfvm_tpu_torch.pipeline import volume as pvol
from effectivediffusivityfvm_tpu_torch.solvers import solvers3d as ts3

torch.set_num_threads(1)
F64 = torch.float64
CPU = torch.device("cpu")


def _d_field(seed, shape, contrast=1e3):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(0, np.log(contrast), shape))


@functools.partial(jax.jit, static_argnames="symmetric")
def _jcoeffs_jit(d, mask, symmetric):
    if mask is None:
        return jax.vmap(lambda a: jfvm3d.fvm_coefficients_3d(a, 0.0, 1.0))(d)
    return jax.vmap(lambda a, m: jfvm3d.fvm_coefficients_3d(
        a, 0.0, 1.0, mask=m, symmetric=symmetric))(d, mask)


def _jcoeffs(d, mask=None, symmetric=False):
    """JAX coefficients of a (B, nz, ny, nx) volume, vmapped (the JAX side
    is jitted whole: op-by-op dispatch would compile every op here)."""
    return _jcoeffs_jit(jnp.asarray(d),
                        None if mask is None else jnp.asarray(mask),
                        symmetric)


@jax.jit
def _jhierarchy(c):
    return js3.build_hierarchy_3d(c, min_size=2, pad_levels=True)


def _assert_fields(got, want, rtol):
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=rtol,
                                   atol=0, err_msg=f)


# ------------------------------------------------------------ assembly


@pytest.mark.parametrize("masked,symmetric",
                         [(False, False), (True, False), (True, True)],
                         ids=["plain", "masked", "symmetric"])
def test_fvm_coefficients_3d_match_jax(masked, symmetric):
    d = _d_field(0, (2, 9, 10, 7))
    mask = (np.random.default_rng(1).uniform(size=d.shape) < 0.2
            if masked else None)
    got = tfvm3d.fvm_coefficients_3d(
        torch.tensor(d), 0.0, 1.0,
        mask=None if mask is None else torch.tensor(mask),
        symmetric=symmetric)
    _assert_fields(got, _jcoeffs(d, mask, symmetric), 1e-12)


@jax.jit
def _j_operator_suite(d, x):
    c = jfvm3d.fvm_coefficients_3d(d, 0.0, 1.0)
    spec = jfvm3d.make_flux_spec_3d(d, 0.0, 1.0)
    return (c, spec, jfvm3d.apply_operator_3d(c, x),
            jfvm3d.neighbor_sum_3d(c, x), jfvm3d.jacobi_sweep_3d(c, x, 0.7),
            jfvm3d.residual_3d(c, x), jfvm3d.equilibrate_3d(c),
            jfvm3d.boundary_deff_3d(spec, x))


def test_operator_flux_and_deff_match_jax():
    d = _d_field(2, (9, 10, 7))
    x = np.random.default_rng(3).standard_normal(d.shape)
    jc, jspec, j_ax, j_nb, j_sw, j_res, (je, jsc), j_deff = \
        _j_operator_suite(jnp.asarray(d), jnp.asarray(x))
    tc = convert.coeffs3d_from_numpy(jc, CPU, F64)
    tx = torch.tensor(x)
    for got, want in ((tfvm3d.apply_operator_3d(tc, tx), j_ax),
                      (tfvm3d.neighbor_sum_3d(tc, tx), j_nb),
                      (tfvm3d.jacobi_sweep_3d(tc, tx, 0.7), j_sw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(tfvm3d.residual_3d(tc, tx)),
                               float(j_res), rtol=1e-12)
    te, ts = tfvm3d.equilibrate_3d(tc)
    _assert_fields(te, je, 1e-12)
    np.testing.assert_allclose(ts.numpy(), np.asarray(jsc), rtol=1e-12)
    tspec = tfvm3d.make_flux_spec_3d(torch.tensor(d), 0.0, 1.0)
    np.testing.assert_allclose(float(tfvm3d.boundary_deff_3d(tspec, tx)),
                               float(j_deff), rtol=1e-12)
    tspec2 = convert.spec3d_from_numpy(jspec, CPU, F64)
    assert float(tfvm3d.boundary_deff_3d(tspec2, tx)) == \
        float(tfvm3d.boundary_deff_3d(tspec, tx))


@pytest.mark.parametrize("shape", [(9, 10, 7), (16, 10, 12)])
def test_coarsen_and_hierarchy_match_jax(shape):
    d = _d_field(4, (2,) + shape)
    jc = _jcoeffs(d)
    tc = tfvm3d.fvm_coefficients_3d(torch.tensor(d), 0.0, 1.0)
    _assert_fields(ts3.coarsen_3d(tc), jax.jit(js3.coarsen_3d)(jc), 1e-12)
    jl = _jhierarchy(jc)
    tl = ts3.build_hierarchy_3d(tc, min_size=2, pad_levels=True)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        _assert_fields(a, b, 1e-12)
    r = np.random.default_rng(5).standard_normal((2,) + tuple(
        2 * (s // 2) for s in shape))
    np.testing.assert_allclose(ts3.restrict_3d(torch.tensor(r)).numpy(),
                               np.asarray(jax.jit(js3.restrict_3d)(r)),
                               rtol=1e-12)
    np.testing.assert_array_equal(ts3.prolong_3d(torch.tensor(r)).numpy(),
                                  np.asarray(jax.jit(js3.prolong_3d)(r)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_volume_model_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vol = (rng.uniform(size=(7, 8, 9)) * 255).astype(np.uint8)
    solid = vol > 110
    a, b = tvolume.flood_fill_3d(solid), jvolume.flood_fill_3d(solid)
    np.testing.assert_array_equal(a.participating, b.participating)
    np.testing.assert_array_equal(a.isolated, b.isolated)
    assert a.path_flag == b.path_flag
    assert tvolume.porosity_3d(vol) == jvolume.porosity_3d(vol)
    np.testing.assert_array_equal(tvolume.amplify_3d(vol, 2, 1, 3),
                                  jvolume.amplify_3d(vol, 2, 1, 3))


@pytest.mark.parametrize("shape", [(256, 256, 256), (100, 64, 90),
                                   (12, 10, 14), (9, 10, 14), (13, 9, 22)])
@pytest.mark.parametrize("item", [4, 8])
def test_band_and_pad_shape_match_jax(shape, item):
    for fields in (12, 18):
        band = tv3.band_z_for(*shape, item, fields=fields)
        assert band == jv3.band_z_for(*shape, item, fields=fields)
        assert tv3.pad_shape_3d(*shape, band) == jv3.pad_shape_3d(*shape,
                                                                  band)


def test_coeffs_from_d3_matches_assembly():
    """The matrix-free rebuild equals the stored assembly to within the
    two harmonic-mean forms' ulps on real voxels; the pads are decoupled."""
    d = _d_field(6, (2, 8, 6, 7))
    c = tfvm3d.fvm_coefficients_3d(torch.tensor(d), 0.0, 1.0)
    lv, mf = ts3.tiled3d_system(c, torch.tensor(d), min_size=2)
    aw, an, au, di = tv3.coeffs_from_d3(mf["d_field"], mf["geom"])
    real = (slice(None), slice(0, 8), slice(0, 6), slice(0, 7))
    for got, want in ((aw, c.a_w), (an, c.a_n), (au, c.a_u),
                      (di, c.diag_inv)):
        np.testing.assert_allclose(got[real].numpy(), want.numpy(),
                                   rtol=1e-14, atol=0)
    assert float(di[..., 7].abs().max()) == 0.0       # the x pad column
    assert lv[0].diag.shape[-1] == 8


# ------------------------------------------------------------ K6


@pytest.fixture(scope="module")
def cycle_case():
    """B=2 x 16x10x12, a JAX hierarchy handed to the port, and the JAX
    kernels' cycles for nu = 1 and 3 (whole and banded, interpret mode)."""
    d = _d_field(7, (2, 16, 10, 12))
    jl = _jhierarchy(_jcoeffs(d))
    tl = convert.levels3d_from_numpy(jl, CPU, F64)
    r = np.random.default_rng(8).standard_normal((2, 16, 10, 12))
    refs = {}
    for nu in (1, 3):
        mg = dict(omega=0.8, nu=nu, coarse_iters=5, over=1.8)
        refs[nu] = (
            np.asarray(jv3.v_cycle3d_pallas(jl, jnp.asarray(r),
                                            interpret=True, **mg)),
            np.asarray(jv3.v_cycle3d_tiled(jl, jnp.asarray(r), band=8,
                                           interpret=True, **mg)))
    return tl, r, refs


@pytest.mark.parametrize("nu", [1, 3])
@pytest.mark.parametrize("banded", [False, True], ids=["whole", "banded"])
def test_v_cycle3d_reference_matches_jax(cycle_case, nu, banded):
    tl, r, refs = cycle_case
    mg = dict(omega=0.8, nu=nu, coarse_iters=5, over=1.8)
    fn = tv3.v_cycle3d_tiled_reference if banded else tv3.v_cycle3d_reference
    z = fn(tl, torch.tensor(r), **mg).numpy()
    want = refs[nu][1 if banded else 0]
    np.testing.assert_allclose(z, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_v_cycle3d_wrappers_take_plain_versions_on_cpu(cycle_case):
    tl, r, _ = cycle_case
    mg = dict(omega=0.8, nu=2, coarse_iters=5, over=1.8)
    counts = (tv3.v_cycle3d.launches, tv3.v_cycle3d_tiled.launches)
    rt = torch.tensor(r)
    assert torch.equal(tv3.v_cycle3d(tl, rt, **mg),
                       tv3.v_cycle3d_reference(tl, rt, **mg))
    assert torch.equal(tv3.v_cycle3d_tiled(tl, rt, **mg),
                       tv3.v_cycle3d_tiled_reference(tl, rt, **mg))
    # the banded cycle is the whole cycle's arithmetic, level by level
    assert torch.equal(tv3.v_cycle3d_tiled_reference(tl, rt, **mg),
                       tv3.v_cycle3d_reference(tl, rt, **mg))
    assert (tv3.v_cycle3d.launches,
            tv3.v_cycle3d_tiled.launches) == counts   # counts launches only
    with pytest.raises(ValueError):
        tv3.v_cycle3d_tiled(tl, rt, omega=0.8, nu=4)


# ------------------------------------------------------------ K7


@pytest.fixture(scope="module")
def cg_case():
    """B=3 on a padded 16x10x12 volume, k=3: volume 0 runs the window, 1 is
    frozen, 2's rz is inflated 1e3x so its first step overshoots and its
    tripwire (hi = 2 sum|r_in|) retires it.  Stored and matrix-free, each
    against the JAX kernel."""
    bsz, k = 3, 3
    d = _d_field(9, (bsz, 16, 10, 11))
    c = tfvm3d.fvm_coefficients_3d(torch.tensor(d), 0.0, 1.0)
    lv, mf = ts3.tiled3d_system(c, torch.tensor(d), min_size=2)
    jl = [jfvm3d.StencilCoeffs3D(*(jnp.asarray(a.numpy()) for a in lvl))
          for lvl in lv]
    mg = dict(omega=0.8, nu=2, coarse_iters=5, over=1.8)
    x = np.zeros(tuple(lv[0].diag.shape))
    r = lv[0].b.numpy().copy()
    p = tv3.v_cycle3d_tiled_reference(lv, lv[0].b, **mg).numpy()
    rz = np.sum(r * p, axis=(1, 2, 3))
    rz[2] *= 1e3
    sr0 = np.sum(np.abs(r), axis=(1, 2, 3))
    active = np.array([1.0, 0.0, 1.0])
    stop = np.zeros(bsz)
    hi = np.array([1e300, 1e300, 2.0 * sr0[2]])
    state = (x, r, p, rz, active, stop, hi)
    refs = {}
    for mode, extra in (("stored", {}),
                        ("matrix-free", dict(
                            d_field=jnp.asarray(mf["d_field"].numpy()),
                            geom=mf["geom"]))):
        out = j_cg_steps3d(jl, *(jnp.asarray(a) for a in state[:3]),
                           *(jnp.asarray(a)[:, None] for a in state[3:]), k,
                           band=8, interpret=True, **mg, **extra)
        refs[mode] = [np.asarray(a) for a in out]
    return lv, mf, state, k, mg, refs


@pytest.mark.parametrize("mode", ["stored", "matrix-free"])
def test_cg_steps3d_reference_matches_jax(cg_case, mode):
    lv, mf, state, k, mg, refs = cg_case
    extra = mf if mode == "matrix-free" else {}
    got = cg_steps3d_reference(lv, *(torch.tensor(a) for a in state), k,
                               **mg, **extra)
    want = refs[mode]
    assert got[4].tolist() == want[4].ravel().tolist() == [3, 0, 1]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-10 * np.abs(w).max())
    np.testing.assert_allclose(got[3].numpy(), want[3].ravel(), rtol=1e-10)
    np.testing.assert_array_equal(got[0][1].numpy(), state[0][1])  # frozen


def test_cg_steps3d_wrapper_takes_plain_version_on_cpu(cg_case):
    lv, mf, state, k, mg, _ = cg_case
    before = cg_steps3d.launches
    a = cg_steps3d(lv, *(torch.tensor(s) for s in state), k, **mg, **mf)
    b = cg_steps3d_reference(lv, *(torch.tensor(s) for s in state), k, **mg,
                             **mf)
    for g, w in zip(a, b):
        assert torch.equal(g, w)
    assert cg_steps3d.launches == before
    with pytest.raises(ValueError):
        cg_steps3d(lv, *(torch.tensor(s) for s in state), k, omega=0.8,
                   nu=2, d_field=mf["d_field"])        # no geom


# ------------------------------------------------------------ the solve


SOLVE_KW = dict(tol=1e-5, max_iter=200, check_every=5,
                criterion="relresidual", nu1=2, nu2=2, coarse_iters=8,
                min_size=4, first_window=1)


@pytest.fixture(scope="module")
def solve_case():
    """B=2 x 8x8x12, contrast 1e4: the JAX fused engine in interpret mode,
    stored and matrix-free."""
    rng = np.random.default_rng(10)
    d = np.where(rng.uniform(size=(2, 8, 8, 12)) < 0.6, 1.0, 1e-4)
    jc = _jcoeffs(d)
    jspec = jax.vmap(lambda a: jfvm3d.make_flux_spec_3d(a, 0.0, 1.0))(
        jnp.asarray(d))
    x0 = np.broadcast_to(np.arange(12) / 12, d.shape).copy()
    refs = {}
    for mode in ("stored", "matrix-free"):
        res = js3.solve_mgcg_3d_batched(
            jc, jspec, jnp.asarray(x0), use_pallas="tiled3d",
            pallas_interpret=True,
            d_field=jnp.asarray(d) if mode == "matrix-free" else None,
            **SOLVE_KW)
        refs[mode] = (np.asarray(res.iters), np.asarray(res.deff),
                      np.asarray(res.conv))
    return d, jc, jspec, x0, refs


@pytest.mark.parametrize("mode", ["stored", "matrix-free"])
def test_solve_mgcg_3d_batched_matches_jax(solve_case, mode):
    d, jc, jspec, x0, refs = solve_case
    c = convert.coeffs3d_from_numpy(jc, CPU, F64)
    spec = convert.spec3d_from_numpy(jspec, CPU, F64)
    res = ts3.solve_mgcg_3d_batched(
        c, spec, torch.tensor(x0),
        d_field=torch.tensor(d) if mode == "matrix-free" else None,
        **SOLVE_KW)
    iters, deff, conv = refs[mode]
    assert res.iters.tolist() == iters.tolist()
    np.testing.assert_allclose(res.deff.numpy(), deff, rtol=1e-9)
    np.testing.assert_allclose(res.conv.numpy(), conv, rtol=1e-6)
    assert np.all(res.conv.numpy() <= SOLVE_KW["tol"])


def test_solve_mgcg_3d_single_matches_batched(solve_case):
    d, jc, jspec, x0, _ = solve_case
    c = convert.coeffs3d_from_numpy(jc, CPU, F64)
    spec = convert.spec3d_from_numpy(jspec, CPU, F64)
    both = ts3.solve_mgcg_3d_batched(c, spec, torch.tensor(x0), **SOLVE_KW)
    one = ts3.solve_mgcg_3d(
        type(c)(*(a[1] for a in c)), type(spec)(*(a[1] for a in spec)),
        torch.tensor(x0[1]), **SOLVE_KW)
    assert int(one.iters) == int(both.iters[1])
    np.testing.assert_allclose(float(one.deff), float(both.deff[1]),
                               rtol=1e-12)


def test_solver_refusals_and_auto_rule():
    assert ts3._engine_auto_3d(2, 2) == "tiled3d"
    assert ts3._engine_auto_3d(3, 3) == "tiled3d"
    d = torch.ones(8, 8, 8, dtype=F64)
    c = tfvm3d.fvm_coefficients_3d(d, 0.0, 1.0)
    spec = tfvm3d.make_flux_spec_3d(d, 0.0, 1.0)
    x0 = torch.zeros_like(d)
    assert float(ts3.solve_mgcg_3d(c, spec, x0, tol=1e-6).conv) <= 1e-6
    # the cycles the fused engine does not take run the plain engine
    assert ts3._engine_auto_3d(1, 2) is False
    assert ts3._engine_auto_3d(4, 4) is False
    for kw in (dict(nu1=1, nu2=2), dict(nu1=4, nu2=4),
               dict(use_pallas=False)):
        assert float(ts3.solve_mgcg_3d(c, spec, x0, tol=1e-6,
                                       **kw).conv) <= 1e-6
    for kw, err in ((dict(use_pallas="tiled3d", nu1=4, nu2=4), ValueError),
                    (dict(use_pallas="tiled"), ValueError),
                    (dict(min_size=8), ValueError)):       # one level only
        with pytest.raises(err):
            ts3.solve_mgcg_3d(c, spec, x0, **kw)
    # rbsor and cg are ported: they run on the same system
    for fn, kw in ((ts3.solve_rbsor_3d, dict(tol=1e-10, check_every=10)),
                   (ts3.solve_cg_3d, dict(tol=1e-10)),
                   (ts3.solve_cg_3d_batched, dict(tol=1e-10))):
        batched = fn is ts3.solve_cg_3d_batched
        args = (c, spec, x0) if not batched else (
            type(c)(*(a[None] for a in c)), type(spec)(*(a[None] for a in spec)),
            x0[None])
        res = fn(*args, criterion="residual", **kw)
        assert float(res.conv.max()) <= 1e-10


# ------------------------------------------------------------ pipelines


def _slab(nz=6, ny=8, nx=10):
    """Fluid in the first half of the y rows, solid in the rest: straight
    channels along x, Deff = eps Df + (1 - eps) Ds."""
    vol = np.full((nz, ny, nx), 255, np.uint8)
    vol[:, : ny // 2, :] = 0
    return vol


@pytest.mark.parametrize("solver", ["mgcg", "jacobi"])
def test_volume_sim_slab_matches_analytic(solver):
    ds = 1e-3
    cfg = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=ds,
                           dtype="float64", solver=solver,
                           criterion="residual", convergence=1e-10,
                           max_iter=20000 if solver == "jacobi" else 200,
                           check_every=10 if solver == "jacobi" else 0)
    res = pvol.volume_sim(cfg, _slab(), device="cpu")
    want = 0.5 + 0.5 * ds
    assert abs(res.deff - want) <= 1e-5 * want
    assert res.n_elements == 6 * 8 * 10 and res.path_flag


def test_volume_sim_3phase_slab_matches_analytic():
    """Fluid, gas and solid layers: Deff = LVF Df + GVF Dg (over Df), with
    the solid masked (Ds = 0) through the symmetric assembly."""
    vol = np.full((6, 8, 10), 255, np.uint8)      # solid
    vol[:, :4, :] = 100                           # fluid
    vol[:, 4:6, :] = 0                            # gas
    cfg = SimulationConfig(n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=200.0,
                           dtype="float64", solver="mgcg",
                           criterion="residual", convergence=1e-9,
                           max_iter=300)
    res = pvol.volume_sim_3phase(cfg, vol, device="cpu")
    want = 0.5 + 0.25 * 200.0
    assert abs(res.deff - want) <= 1e-5 * want
    assert (res.svf, res.lvf) == (0.25, 0.5)


def _medium(seed, shape=(8, 8, 12)):
    rng = np.random.default_rng(seed)
    return np.where(rng.uniform(size=shape) < 0.65, 0, 255).astype(np.uint8)


def test_cli_npy_route_matches_volume_sim(tmp_path):
    vol = _medium(11)
    np.save(tmp_path / "vol.npy", vol)
    np.savez(tmp_path / "vol2.npz", vol)
    common = ("Phases: 2\nDs: 1e-3\nDf: 1\nSolver: mgcg\n"
              "Criterion: residual\nConvergence: 1e-9\nDtype: float64\n")
    for name in ("vol.npy", "vol2.npz"):
        out = tmp_path / f"{name}.csv"
        inp = tmp_path / f"input_{name}.txt"
        inp.write_text(f"{common}InputName: {tmp_path / name}\n"
                       f"OutputName: {out}\n")
        assert cli.main([str(inp)], device="cpu") == 0
        rows = out.read_text().splitlines()
        assert len(rows) == 2
        cfg = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=1e-3,
                               dtype="float64", solver="mgcg",
                               criterion="residual", convergence=1e-9)
        direct = pvol.volume_sim(cfg, vol, device="cpu")
        deff_csv = float(rows[1].split(",")[3])     # written with %f
        assert abs(deff_csv - direct.deff) <= 1e-6


def test_cli_batch_npy_route_matches_singles(tmp_path):
    vols = [_medium(20 + i) for i in range(3)]
    for i, v in enumerate(vols):
        np.save(tmp_path / f"{i:05d}.npy", v)
    out = tmp_path / "batch.csv"
    inp = tmp_path / "input.txt"
    inp.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: 3\nImageDir: "
                   f"{tmp_path}\nDs: 1e-3\nDf: 1\nSolver: mgcg\n"
                   f"Criterion: residual\nConvergence: 1e-9\n"
                   f"Dtype: float64\nOutputName: {out}\n")
    assert cli.main([str(inp)], device="cpu") == 0
    rows = [r.split(",") for r in out.read_text().splitlines()
            if r.split(",")[0].isdigit()]
    assert [int(r[0]) for r in rows] == [0, 1, 2]
    cfg = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=1e-3,
                           dtype="float64", solver="mgcg",
                           criterion="residual", convergence=1e-9)
    for r, v in zip(rows, vols):
        single = pvol.volume_sim(cfg, v, device="cpu")
        assert abs(float(r[3]) - single.deff) <= 1e-6     # written with %f
        assert int(r[5]) == v.size


def test_volume_batch_sim_3phase_rows_match_singles(tmp_path):
    vols = []
    for seed in (30, 31):
        v = _medium(seed, (6, 8, 10)).copy()
        v[:, :2, :] = 0          # a gas channel keeps it percolating
        v[:, 2:4, :] = 100       # and a fluid one
        vols.append(v)
    cfg = SimulationConfig(n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=20.0,
                           dtype="float64", solver="mgcg",
                           criterion="residual", convergence=1e-9,
                           max_iter=300, incremental_output=False,
                           output_name=str(tmp_path / "b3.csv"))
    table = pvol.volume_batch_sim_3phase(cfg, vols, device="cpu")
    for k, v in enumerate(vols):
        single = pvol.volume_sim_3phase(cfg, v, device="cpu")
        assert abs(table[k, 4] - single.deff) <= 1e-6 * abs(single.deff)
        assert (table[k, 1], table[k, 2]) == (single.svf, single.lvf)
    assert len((tmp_path / "b3.csv").read_text().splitlines()) == 3


def test_volume_solver_substitution_and_refusals():
    cfg = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=1e-3,
                           dtype="float64", solver="cgir")
    with pytest.warns(UserWarning, match="no 3D implementation"):
        assert pvol._effective_solver_3d(cfg) == "mgcg"
    for name in ("rbsor", "cg", "dmg"):
        cfg = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=1e-3,
                               dtype="float64", solver=name,
                               criterion="residual", convergence=1e-10,
                               check_every=10)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            # rbsor, cg and dmg (solvers/dmg3d.py, undeflated on a 2-phase
            # volume) run, without substitution
            res = pvol.volume_sim(cfg, _slab(6, 6, 6), device="cpu")
            want = 0.5 + 0.5 * 1e-3
            assert abs(res.deff - want) <= 1e-5 * want
