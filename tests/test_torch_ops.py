"""The torch port's numpy/torch modules against the JAX package, on the CPU.

Inputs come from ``np.random.default_rng`` and go to both packages; the
comparison runs in float64 (conftest enables x64).  Assembly, flux and the
hierarchy are elementwise formulas and short fixed-shape sums, so they agree
to a few ulp: rtol 1e-13.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.models import phases as jphases
from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import boundary_deff as j_deff
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as j_spec
from effectivediffusivityfvm_tpu.solvers import driver as jdriver
from effectivediffusivityfvm_tpu.solvers import multigrid as jmg
from effectivediffusivityfvm_tpu.solvers.multigrid import \
    build_hierarchy as j_hier
from effectivediffusivityfvm_tpu_torch import convert
from effectivediffusivityfvm_tpu_torch.models import phases as tphases
from effectivediffusivityfvm_tpu_torch.ops import fvm as tfvm
from effectivediffusivityfvm_tpu_torch.ops.flux import boundary_deff as t_deff
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec as t_spec
from effectivediffusivityfvm_tpu_torch.solvers import driver as tdriver
from effectivediffusivityfvm_tpu_torch.solvers import multigrid as tmg
from effectivediffusivityfvm_tpu_torch.solvers.multigrid import \
    build_hierarchy as t_hier

RTOL = 1e-13
F64 = torch.float64
# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol,
                               atol=0)


@pytest.fixture(scope="module")
def field():
    """A (3, 15, 23) lognormal diffusivity field, contrast 1e4, and a mask."""
    rng = np.random.default_rng(11)
    d = np.exp(rng.uniform(0, np.log(1e4), (3, 15, 23)))
    mask = rng.random((3, 15, 23)) < 0.2
    x = rng.random((3, 15, 23))
    return d, mask, x


def test_phases_match_exactly():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (17, 29), dtype=np.uint8)
    for name in ("two_phase_classes", "three_phase_classes"):
        np.testing.assert_array_equal(getattr(tphases, name)(img),
                                      getattr(jphases, name)(img))
    cls = jphases.three_phase_classes(img)
    np.testing.assert_array_equal(tphases.amplify(cls, 2, 3),
                                  jphases.amplify(cls, 2, 3))
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(
            tphases.d_field_from_classes(cls, 1.0, 1e-6, 0.5, dtype=dt),
            jphases.d_field_from_classes(cls, 1.0, 1e-6, 0.5, dtype=dt))
    assert tphases.porosity(img) == jphases.porosity(img)
    assert tphases.phase_fractions(cls) == jphases.phase_fractions(cls)


@pytest.mark.parametrize("mode", ["plain", "mask", "mask_symmetric"])
def test_fvm_coefficients_match(field, mode):
    d, mask, _ = field
    m = None if mode == "plain" else mask
    sym = mode == "mask_symmetric"
    dj = jnp.asarray(d)
    if m is None:
        ref = jax.vmap(lambda dd: jfvm.fvm_coefficients(dd, 0.0, 1.0))(dj)
    else:
        ref = jax.vmap(lambda dd, mm: jfvm.fvm_coefficients(
            dd, 0.0, 1.0, mask=mm, symmetric=sym))(dj, jnp.asarray(m))
    got = tfvm.fvm_coefficients(torch.tensor(d), 0.0, 1.0,
                                mask=None if m is None else torch.tensor(m),
                                symmetric=sym)
    for f in tfvm.StencilCoeffs._fields:
        _close(getattr(ref, f), getattr(got, f))


def test_operators_match(field):
    d, _, x = field
    cj = jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(
        jnp.asarray(d), 0.2, 0.9)
    ct = tfvm.fvm_coefficients(torch.tensor(d), 0.2, 0.9)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    _close(jfvm.neighbor_sum(cj, xj), tfvm.neighbor_sum(ct, xt))
    _close(jfvm.apply_operator(cj, xj), tfvm.apply_operator(ct, xt))
    _close(jfvm.residual(cj, xj), tfvm.residual(ct, xt))
    _close(jfvm.jacobi_sweep(cj, xj, 0.8), tfvm.jacobi_sweep(ct, xt, 0.8))


def test_harmonic_mean_zero_handling():
    a = np.array([0.0, 1.0, 0.0, 2.0])
    b = np.array([1.0, 0.0, 0.0, 3.0])
    ref = np.asarray(jfvm.harmonic_mean(jnp.asarray(a), jnp.asarray(b)))
    got = tfvm.harmonic_mean(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.isnan(got).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_boundary_deff_matches(field, dtype):
    d, _, x = field
    d, x = d.astype(dtype), x.astype(dtype)
    sj = jax.vmap(j_spec, in_axes=(0, None, None))(jnp.asarray(d), 0.0, 1.0)
    st = t_spec(torch.tensor(d), 0.0, 1.0)
    for f in ("d_left", "d_right", "c_left", "c_right", "inv_half_dx"):
        _close(getattr(sj, f), getattr(st, f))
    got = t_deff(st, torch.tensor(x))
    assert got.dtype == torch.tensor(x).dtype
    _close(j_deff(sj, jnp.asarray(x)), got,
           rtol=RTOL if dtype == np.float64 else 1e-6)


def test_restrict_and_prolong_match(field):
    _, _, x = field
    even = x[:, :14, :22]
    _close(jmg.restrict(jnp.asarray(even)), tmg.restrict(torch.tensor(even)))
    _close(jmg.prolong(jnp.asarray(x)), tmg.prolong(torch.tensor(x)))


@pytest.mark.parametrize("pad_levels", [True, False])
def test_build_hierarchy_matches_level_by_level(field, pad_levels):
    d, _, _ = field
    cj = jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(
        jnp.asarray(d), 0.0, 1.0)
    ct = tfvm.fvm_coefficients(torch.tensor(d), 0.0, 1.0)
    lj = j_hier(cj, min_size=4, pad_levels=pad_levels)
    lt = t_hier(ct, min_size=4, pad_levels=pad_levels)
    assert [c.diag.shape for c in lj] == [tuple(c.diag.shape) for c in lt]
    for a, b in zip(lj, lt):
        for f in tfvm.StencilCoeffs._fields:
            _close(getattr(a, f), getattr(b, f))


def test_convert_carries_the_jax_hierarchy(field):
    d, _, _ = field
    cj = jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(
        jnp.asarray(d), 0.0, 1.0)
    lj = j_hier(cj, min_size=4, pad_levels=True)
    lt = convert.levels_from_numpy(lj, "cpu", torch.float32)
    assert len(lt) == len(lj)
    for a, b in zip(lj, lt):
        assert b.a_w.dtype == torch.float32 and b.a_w.device.type == "cpu"
        np.testing.assert_array_equal(b.diag_inv.numpy(),
                                      np.asarray(a.diag_inv, np.float32))
    sj = jax.vmap(j_spec, in_axes=(0, None, None))(jnp.asarray(d), 0.0, 1.0)
    st = convert.spec_from_numpy(sj, "cpu", F64)
    np.testing.assert_array_equal(st.d_left.numpy(), np.asarray(sj.d_left))


@pytest.mark.parametrize("args", [(0, 40, "residual", False),
                                  (0, 40, "deff", False),
                                  (0, 10, "relresidual", True),
                                  (5, 40, "residual", False)])
def test_resolve_first_window_matches(args):
    assert tdriver.resolve_first_window(*args) == \
        jdriver.resolve_first_window(*args)


@pytest.mark.parametrize("args", [(0, 10), (-1, 10), (None, 10), (25, 10)])
def test_resolve_check_every_matches(args):
    assert tdriver.resolve_check_every(*args) == \
        jdriver.resolve_check_every(*args)
