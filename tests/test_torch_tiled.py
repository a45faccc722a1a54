"""The port's banded engine (``use_pallas="tiled"``: K4 ``v_cycle_tiled``,
K5 ``cg_steps_tiled``, the matrix-free level 0 and the solve) against the
JAX package's, run in interpret mode on the CPU, in float64.

Both sides get the identical hierarchy (the port's, handed to JAX through
numpy) and identical state.  The cycle is a fixed sequence of stencil
passes: rtol 1e-11.  The CG steps add full-plane dot products whose
summation order differs between XLA and torch, amplified over k=4
iterations: rtol 1e-10.  The solve compares Deff at rtol 1e-9 with
identical iteration counts.  The JAX references are the cost here, so each
is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as jspec
from effectivediffusivityfvm_tpu.ops.kernels import vcycle_tiled as jvt
from effectivediffusivityfvm_tpu.ops.kernels.cgstep_tiled import \
    cg_steps_tiled as j_cg_steps_tiled
from effectivediffusivityfvm_tpu.ops.kernels.vcycle_vmem import \
    vcycle_fits_vmem
from effectivediffusivityfvm_tpu.solvers.multigrid import \
    solve_mgcg_batched as j_solve
from effectivediffusivityfvm_tpu_torch.ops import fvm as tfvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle_tiled as tvt
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import (
    cg_steps_tiled, cg_steps_tiled_reference, coeffs_from_d)
from effectivediffusivityfvm_tpu_torch.solvers import multigrid

MG = dict(omega=(1.281, 0.5584), nu=2, coarse_iters=8, over=1.8)
BAND = 8
torch.set_num_threads(1)


def _case(seed, bsz, ny, nx, contrast=1e3):
    """D, the port's padded hierarchy (as torch and as JAX arrays), the
    padded D and the matrix-free geometry."""
    rng = np.random.default_rng(seed)
    d = np.exp(rng.uniform(0, np.log(contrast), (bsz, ny, nx)))
    c = tfvm.fvm_coefficients(torch.tensor(d), 0.0, 1.0)
    lv, mf = multigrid.tiled_system(c, torch.tensor(d), min_size=4)
    assert lv[0].diag.shape[-2] % BAND == 0
    jlv = [jfvm.StencilCoeffs(*(jnp.asarray(a.numpy()) for a in lvl))
           for lvl in lv]
    return d, lv, jlv, mf["d_field"].numpy(), mf["geom"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(20, 28), (512, 512), (1278, 1278),
                                   (1280, 1280), (2007, 1002), (2048, 2048)])
def test_shapes_and_engine_choice_match_jax(shape, dtype):
    ny, nx = shape
    item = 4 if dtype == "float32" else 8
    band = tvt.tiled_band(ny, nx, item)
    assert band == jvt.tiled_band(ny, nx, item)
    assert tvt.tiled_pad_shape(ny, nx, band) == jvt.tiled_pad_shape(ny, nx,
                                                                    band)
    even = (ny + ny % 2, nx + nx % 2)
    want = ("tiled" if dtype == "float32" and not vcycle_fits_vmem(*even)
            else "cgstep")
    assert multigrid._engine_auto(ny, nx, getattr(torch, dtype)) == want
    assert tvt.fits_whole_cycle(*even) == vcycle_fits_vmem(*even)


@pytest.fixture(scope="module")
def cycle_case():
    _, lv, jlv, _, _ = _case(5, 2, 32, 24)
    rng = np.random.default_rng(6)
    py, px = lv[0].diag.shape[-2:]
    r = np.zeros((2, py, px))
    r[:, :32, :24] = rng.standard_normal((2, 32, 24))
    z = np.asarray(jvt.v_cycle_tiled(jlv, jnp.asarray(r), band=BAND,
                                     interpret=True, **MG))
    return lv, r, z


def test_v_cycle_tiled_reference_matches_jax(cycle_case):
    lv, r, z_ref = cycle_case
    z = tvt.v_cycle_tiled_reference(lv, torch.tensor(r), **MG)
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-11,
                               atol=1e-11 * np.abs(z_ref).max())


def test_v_cycle_tiled_wrapper_takes_plain_version_on_cpu(cycle_case):
    lv, r, _ = cycle_case
    before = tvt.v_cycle_tiled.launches
    got = tvt.v_cycle_tiled(lv, torch.tensor(r), **MG)
    assert torch.equal(got, tvt.v_cycle_tiled_reference(lv, torch.tensor(r),
                                                        **MG))
    assert tvt.v_cycle_tiled.launches == before   # counts launches only


@pytest.fixture(scope="module")
def cg_case():
    """B=2 on four bands of 8 rows, k=4: image 0 runs the window; image 1's
    rz is inflated 1e3x, so its first step overshoots and its tripwire
    (hi = 2 sum|r_in|) retires it after one iteration.  Stored and
    matrix-free, each against the JAX kernel."""
    bsz, k = 2, 4
    _, lv, jlv, d_pad, geom = _case(9, bsz, 32, 24)
    py, px = d_pad.shape[-2:]
    x = np.zeros((bsz, py, px))
    r = lv[0].b.numpy()
    p = tvt.v_cycle_tiled_reference(lv, lv[0].b, **MG).numpy()
    rz = np.sum(r * p, axis=(-2, -1))
    rz[1] *= 1e3
    sr0 = np.sum(np.abs(r), axis=(-2, -1))
    active = np.ones(bsz)
    stop = np.zeros(bsz)
    hi = np.array([1e300, 2.0 * sr0[1]])
    state = (x, r, p, rz, active, stop, hi)
    refs = {}
    for mode, extra in (("stored", {}),
                        ("matrix-free", dict(d_field=jnp.asarray(d_pad),
                                             geom=geom))):
        out = j_cg_steps_tiled(
            jlv, *(jnp.asarray(a) for a in (x, r, p)),
            *(jnp.asarray(a)[:, None] for a in (rz, active, stop, hi)),
            jnp.asarray(k, jnp.int32), band=BAND, interpret=True, **MG,
            **extra)
        ref = [np.asarray(o) for o in out]
        refs[mode] = ref[:3] + [a[:, 0] for a in ref[3:]]
    return lv, d_pad, geom, state, k, refs


@pytest.mark.parametrize("mode", ["stored", "matrix-free"])
def test_cg_steps_tiled_reference_matches_jax(cg_case, mode):
    lv, d_pad, geom, state, k, refs = cg_case
    extra = ({} if mode == "stored"
             else dict(d_field=torch.tensor(d_pad), geom=geom))
    got = cg_steps_tiled_reference(lv, *(torch.tensor(a) for a in state), k,
                                   **MG, **extra)
    got = [o.numpy() for o in got]
    ref = refs[mode]
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[4], [k, 1])
    for g, e in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(g, e, rtol=1e-10,
                                   atol=1e-10 * np.abs(e).max())


def test_cg_steps_tiled_frozen_and_in_place(cg_case):
    """A frozen image comes back unchanged with k_done 0; x/r/p are
    updated in place; on a CPU tensor the wrapper is the plain version."""
    lv, _, _, state, k, _ = cg_case
    t = [torch.tensor(a) for a in state]
    t[4][0] = 0.0
    keep = [a.clone() for a in t]
    before = cg_steps_tiled.launches
    out = cg_steps_tiled(lv, *t, k, **MG)
    assert cg_steps_tiled.launches == before
    for o, i in zip(out[:3], t[:3]):
        assert o is i
    assert out[4].tolist() == [0, 1]
    for o, a in zip(out[:4], keep[:4]):
        assert torch.equal(o[0], a[0])


def test_coeffs_from_d_matches_assembly():
    """The matrix-free rebuild against the stored assembly: 1-2 ulp on real
    cells (product- vs reciprocal-form harmonic mean), diag_inv 0 on the
    pads."""
    d, lv, _, d_pad, geom = _case(3, 2, 20, 28, contrast=1e4)
    aw, an, di = coeffs_from_d(torch.tensor(d_pad), geom)
    c0 = lv[0]
    for got, want in ((aw, c0.a_w), (an, c0.a_n), (di, c0.diag_inv)):
        np.testing.assert_allclose(got[:, :20, :28].numpy(),
                                   want[:, :20, :28].numpy(), rtol=1e-14)
    assert float(di[:, 20:].abs().max()) == 0.0
    assert float(di[:, :, 28:].abs().max()) == 0.0


def _problem(seed, bsz, ny, nx, contrast=1e4):
    rng = np.random.default_rng(seed)
    d = np.exp(rng.uniform(0, np.log(contrast), (bsz, ny, nx)))
    x0 = np.broadcast_to(np.arange(nx) / nx, (bsz, ny, nx))
    return d, x0


def _port_solve(d, x0, **kw):
    dt = torch.tensor(d)
    return multigrid.solve_mgcg_batched(
        tfvm.fvm_coefficients(dt, 0.0, 1.0), make_flux_spec(dt, 0.0, 1.0),
        torch.tensor(x0), **kw)


SOLVE_KW = dict(tol=1e-12, max_iter=19, check_every=4, first_window=1,
                criterion="residual", nu1=2, nu2=2, min_size=4,
                coarse_iters=8, mg_omega=MG["omega"])


def test_tiled_solve_matches_jax():
    """B=2, 20x28 (padded on both axes): windows of 1, 4, 4, 4, 4 and a
    window cut to 2 by max_iter, each followed by the refresh."""
    d, x0 = _problem(11, 2, 20, 28)
    dj = jnp.asarray(d)
    ref = j_solve(jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(
        dj, 0.0, 1.0), jax.vmap(jspec, in_axes=(0, None, None))(dj, 0.0, 1.0),
        jnp.asarray(x0), use_pallas="tiled", pallas_interpret=True,
        **SOLVE_KW)
    got = _port_solve(d, x0, use_pallas="tiled", **SOLVE_KW)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.iters.numpy(), [19, 19])
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=1e-9)
    np.testing.assert_allclose(got.conv.numpy(), np.asarray(ref.conv),
                               rtol=1e-6)


def test_matrix_free_solve_matches_stored():
    """On an unpadded 24x256 grid the rebuilt level 0 is within 1-2 ulp of
    the stored one: the matrix-free solve matches the stored solve."""
    d, x0 = _problem(12, 2, 24, 256)
    kw = dict(tol=1e-5, max_iter=200, check_every=10, first_window=1,
              criterion="relresidual", nu1=2, nu2=2, use_pallas="tiled")
    ref = _port_solve(d, x0, **kw)
    got = _port_solve(d, x0, d_field=torch.tensor(d), **kw)
    np.testing.assert_array_equal(got.iters.numpy(), ref.iters.numpy())
    assert np.all(got.conv.numpy() <= 1e-5)
    assert np.all(got.iters.numpy() < 200)
    np.testing.assert_allclose(got.deff.numpy(), ref.deff.numpy(), rtol=1e-9)


@pytest.mark.parametrize("use_pallas", [False, True, "tiledcycle"])
def test_engines_not_ported_raise(use_pallas):
    """The cycle-only engines, refused before they were ported, run under
    run_pcg (tests/test_torch_general_cycle.py holds them against the JAX
    package): each converges to the fused "cgstep" solve's Deff."""
    d, x0 = _problem(13, 2, 20, 28)
    kw = dict(tol=1e-10, max_iter=300, check_every=10,
              criterion="relresidual", nu1=2, nu2=2, min_size=4,
              coarse_iters=8)
    ref = _port_solve(d, x0, use_pallas="cgstep", **kw)
    got = _port_solve(d, x0, use_pallas=use_pallas, **kw)
    assert np.all(got.conv.numpy() <= 1e-10)
    np.testing.assert_allclose(got.deff.numpy(), ref.deff.numpy(),
                               rtol=1e-8)
