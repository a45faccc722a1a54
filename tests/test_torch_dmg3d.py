"""The port's 3D deflated MGCG (``solvers/dmg3d.py``) against the JAX
package's on the CPU, in float64: the labelling, the assembly of ``E = W^T
A W`` and the factored space, ``solve_dmg_3d`` and
``solve_dmg_3d_batched`` on K6's plain versions, and ``volume_sim_3phase``
with ``Solver: dmg``; then the port alone: the forced banded cycle, the
engine rule and the refusals.

The JAX XLA ``v_cycle_3d`` compiles for about 100 s at 16^3 here, so the
JAX side runs its K6 Pallas cycle (``v_cycle3d_pallas``) in interpret mode
on the even-padded hierarchy: a test-side monkeypatch of the module's
``v_cycle_3d`` and ``build_hierarchy_3d``, under a ``jax.jit`` of the
solve's own (the module's jit cache is left alone).  Nothing in the JAX
package changes.

Tolerances: labels equal; E rtol 1e-12 (host sums against a device
matmul), its scaled inverse factors rtol 1e-11 (E's rounding through a
square root and an inverse of a 5x5 matrix); the solves identical iterations within 1 and Deff rtol
1e-8 (float32 cycles).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.config import \
    SimulationConfig as JSimulationConfig
from effectivediffusivityfvm_tpu.ops import fvm3d as jfvm3d
from effectivediffusivityfvm_tpu.ops.kernels.vcycle3d import v_cycle3d_pallas
from effectivediffusivityfvm_tpu.pipeline import volume as jpvol
from effectivediffusivityfvm_tpu.solvers import dmg3d as jdmg3d
from effectivediffusivityfvm_tpu.solvers import solvers3d as js3
from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
from effectivediffusivityfvm_tpu_torch.models import phases, volume
from effectivediffusivityfvm_tpu_torch.ops import fvm3d
from effectivediffusivityfvm_tpu_torch.pipeline import volume as pvol
from effectivediffusivityfvm_tpu_torch.solvers import dmg3d

torch.set_num_threads(1)


def gas_volume(seed, n=16):
    """A 3-phase voxel volume: fluid (150) with gas balls (0), a gas slab
    through each x face (the Dirichlet planes), then solid balls (255)."""
    rng = np.random.default_rng(seed)
    v = np.full((n, n, n), 150, np.uint8)
    kk, ii, jj = np.ogrid[:n, :n, :n]
    for _ in range(6):
        c = rng.integers(0, n, 3)
        r = rng.integers(2, 4)
        v[(kk - c[0]) ** 2 + (ii - c[1]) ** 2 + (jj - c[2]) ** 2 < r * r] = 0
    v[:, 3:6, :4] = 0
    v[:, 9:12, -4:] = 0
    for _ in range(3):
        c = rng.integers(0, n, 3)
        v[(kk - c[0]) ** 2 + (ii - c[1]) ** 2 + (jj - c[2]) ** 2 < 4] = 255
    return v


def _system(v, dg=1e4):
    """Port and JAX systems of a 3-phase volume (symmetric masked
    assembly, float64) and its gas mask."""
    classes = phases.three_phase_classes(v)
    ff = volume.flood_fill_3d(v > 200)
    mask = (v > 200) | ff.isolated
    gas = (classes == phases.GAS) & ~mask
    d = phases.d_field_from_classes(classes, 1.0, 0.0, dg, dtype=np.float64)
    n = v.shape[-1]
    c = fvm3d.fvm_coefficients_3d(torch.tensor(d), 0.0, 1.0,
                                  mask=torch.tensor(mask), symmetric=True)
    s = fvm3d.make_flux_spec_3d(torch.tensor(d), 0.0, 1.0)
    x0 = (torch.arange(n, dtype=torch.float64) / n).expand(v.shape).clone()
    jc = jfvm3d.fvm_coefficients_3d(jnp.asarray(d), 0.0, 1.0,
                                    mask=jnp.asarray(mask), symmetric=True)
    js = jfvm3d.make_flux_spec_3d(jnp.asarray(d), 0.0, 1.0)
    return (c, s, x0), (jc, js, jnp.asarray(x0.numpy())), gas


def _pallas_cycle(levels, r, *, nu1, nu2, omega, coarse_iters, over):
    """JAX's K6 whole cycle in interpret mode in place of its XLA
    ``v_cycle_3d`` (V(nu, nu) on the even-padded hierarchy)."""
    assert nu1 == nu2
    pz, py, px = levels[0].diag.shape[-3:]
    nz, ny, nx = r.shape[-3:]
    rp = jnp.pad(r, [(0, pz - nz), (0, py - ny), (0, px - nx)])
    z = v_cycle3d_pallas(levels, rp[None], omega=omega, nu=nu1,
                         coarse_iters=coarse_iters, over=over,
                         interpret=True)
    return z[0, :nz, :ny, :nx]


@pytest.fixture
def jax_on_k6(monkeypatch):
    """Pin the JAX dmg3d to its K6 Pallas cycle in interpret mode."""
    monkeypatch.setattr(jdmg3d, "v_cycle_3d", _pallas_cycle)
    monkeypatch.setattr(jdmg3d, "build_hierarchy_3d", functools.partial(
        js3.build_hierarchy_3d, pad_levels=True))
    monkeypatch.setattr(jdmg3d, "_solve_dmg_3d_jit", jax.jit(
        jdmg3d._solve_dmg_3d_jit.__wrapped__, static_argnames=(
            "omega", "tol", "max_iter", "check_every", "criterion", "m",
            "nu", "mg_omega", "coarse_iters", "min_size", "over",
            "precond_f32")))


@pytest.fixture(scope="module")
def case():
    return _system(gas_volume(1))


# ------------------------------------------------------------ the space

def test_labels_and_e_assembly_match_jax(case):
    (c, _, _), (jc, _, _), gas = case
    lab = dmg3d.label_components_3d(gas)
    np.testing.assert_array_equal(lab, jdmg3d.label_components_3d(gas))
    m = int(lab.max()) + 1
    assert m >= 3
    e = dmg3d._assemble_e_host_3d(c, lab, m)
    np.testing.assert_allclose(e, jdmg3d._assemble_e_3d(jc, lab, m),
                               rtol=1e-12, atol=1e-12 * np.abs(e).max())


def test_component_deflation_3d_matches_jax(case):
    (c, _, _), (jc, _, _), gas = case
    got = dmg3d.build_component_deflation_3d(c, gas)
    want = jdmg3d.build_component_deflation_3d(jc, gas)
    assert got.m == want.m
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    for a, b in ((got.e_hat_inv, want.e_hat_inv),
                 (got.dhalf_inv, want.dhalf_inv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11)
    assert dmg3d.build_component_deflation_3d(c, np.zeros_like(gas)) is None


# ------------------------------------------------------------ the solves

@pytest.mark.parametrize("deflated", [True, False])
def test_solve_dmg_3d_matches_jax(case, jax_on_k6, deflated):
    (c, s, x0), (jc, js, jx0), gas = case
    member = gas if deflated else None
    kw = dict(check_every=10, criterion="relresidual", tol=1e-10)
    got = dmg3d.solve_dmg_3d(c, s, x0, member=member, **kw)
    want = jdmg3d.solve_dmg_3d(jc, js, jx0, member=member, **kw)
    assert abs(int(got.iters) - int(want.iters)) <= 1
    assert float(got.conv) <= 1e-10
    np.testing.assert_allclose(float(got.deff), float(want.deff), rtol=1e-8)


def test_solve_dmg_3d_batched_matches_jax(jax_on_k6):
    cases = [_system(gas_volume(seed, 12)) for seed in (2, 3)]
    c, s, x0 = (type(t)(*(torch.stack(f) for f in zip(*ts)))
                if isinstance(t, tuple) else torch.stack(ts)
                for t, ts in zip(cases[0][0], zip(*(cs[0] for cs in cases))))
    gas = np.stack([cs[2] for cs in cases])
    kw = dict(check_every=10, criterion="relresidual", tol=1e-10)
    got = dmg3d.solve_dmg_3d_batched(c, s, x0, members=gas, **kw)
    for k, cs in enumerate(cases):
        want = jdmg3d.solve_dmg_3d(*cs[1], member=cs[2], **kw)
        assert abs(int(got.iters[k]) - int(want.iters)) <= 1
        np.testing.assert_allclose(float(got.deff[k]), float(want.deff),
                                   rtol=1e-8)


def test_volume_sim_3phase_dmg_matches_jax(jax_on_k6):
    vol = gas_volume(4, 12)
    kw = dict(n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=1e4,
              dtype="float64", solver="dmg", criterion="relresidual",
              convergence=1e-10, max_iter=500, check_every=10)
    got = pvol.volume_sim_3phase(SimulationConfig(**kw), vol, device="cpu")
    want = jpvol.volume_sim_3phase(JSimulationConfig(**kw), vol)
    assert abs(got.iters - want.iters) <= 1
    assert got.conv <= 1e-10
    np.testing.assert_allclose(got.deff, want.deff, rtol=1e-8)
    assert (got.svf, got.lvf) == (want.svf, want.lvf)


# ------------------------------------------------------------ port only

def test_banded_cycle_gives_the_whole_cycle_solve(case):
    (c, s, x0), _, gas = case
    kw = dict(check_every=10, member=gas)
    whole = dmg3d.solve_dmg_3d(c, s, x0, use_pallas=True, **kw)
    banded = dmg3d.solve_dmg_3d(c, s, x0, use_pallas="tiled3d", **kw)
    assert int(whole.iters) == int(banded.iters)
    np.testing.assert_allclose(float(banded.deff), float(whole.deff),
                               rtol=1e-12)


def test_engine_rule_and_refusals(case):
    (c, s, x0), _, _ = case
    f32, f64 = torch.float32, torch.float64
    # K6's whole cycle at every size (on the card faster than the banded
    # one, or within 1% of it, at each size measured)
    for shape in ((16, 16, 16), (90, 89, 90), (92, 92, 92), (256,) * 3):
        assert dmg3d._dmg3d_engine_auto(shape, f32, 2) is True
    assert dmg3d._dmg3d_engine_auto((80,) * 3, f64, 3) is True
    # past K6's nu, and with use_pallas=False, the plain torch cycle
    assert dmg3d._dmg3d_engine_auto((16,) * 3, f32, 4) is False
    with pytest.raises(ValueError, match="nu=4"):
        dmg3d.solve_dmg_3d(c, s, x0, use_pallas=True, nu=4)
    kw = dict(tol=1e-10, max_iter=300)
    plain = dmg3d.solve_dmg_3d(c, s, x0, use_pallas=False, **kw)
    whole = dmg3d.solve_dmg_3d(c, s, x0, **kw)
    assert float(plain.conv) <= 1e-10
    np.testing.assert_allclose(float(plain.deff), float(whole.deff),
                               rtol=1e-8)
    with pytest.raises(ValueError, match="f64"):
        dmg3d.solve_dmg_3d(fvm3d.StencilCoeffs3D(*(a.float() for a in c)),
                           s, x0.float())
    cfg = dataclasses.replace(SimulationConfig(dtype="float64"), solver="dmg")
    assert pvol._effective_solver_3d(cfg) == "dmg"


def test_a_pore_reached_only_across_the_wrap_stays_finite(jax_on_k6):
    """A fluid voxel in the corner whose only fluid neighbours lie across
    the flood fill's periodic y/z wrap is participating, but the operator
    has no conductance there (diag 0).  The JAX equilibration divides by
    its sqrt(0) and the solve returns NaN; the port makes the row a
    decoupled identity row (``fvm.decouple_empty_rows``), and the solve
    equals the JAX solve of the volume with that voxel masked (the cell
    carries no flux)."""
    vol = gas_volume(5, 12)
    vol[-1, -1, 5] = 150
    vol[-2, -1, 5] = vol[-1, -2, 5] = vol[-1, -1, 4] = vol[-1, -1, 6] = 255
    vol[0, -1, 5] = vol[-1, 0, 5] = 150
    (c, s, x0), (jc, js, jx0), gas = _system(vol)
    assert float(c.diag[-1, -1, 5]) == 0.0
    kw = dict(check_every=10, criterion="relresidual", tol=1e-10)
    got = dmg3d.solve_dmg_3d(c, s, x0, member=gas, **kw)
    assert np.isfinite(float(got.deff)) and float(got.conv) <= 1e-10
    want_nan = jdmg3d.solve_dmg_3d(jc, js, jx0, member=gas, **kw)
    assert not np.isfinite(float(want_nan.conv))
    mask = np.zeros(vol.shape, bool)
    mask[-1, -1, 5] = True
    jc_m = jfvm3d.fvm_coefficients_3d(
        jnp.asarray(phases.d_field_from_classes(
            phases.three_phase_classes(vol), 1.0, 0.0, 1e4,
            dtype=np.float64)), 0.0, 1.0,
        mask=jnp.asarray((vol > 200) | volume.flood_fill_3d(vol > 200)
                         .isolated | mask), symmetric=True)
    want = jdmg3d.solve_dmg_3d(jc_m, js, jx0, member=gas, **kw)
    assert abs(int(got.iters) - int(want.iters)) <= 1
    np.testing.assert_allclose(float(got.deff), float(want.deff), rtol=1e-8)
