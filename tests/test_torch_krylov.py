"""The port's Krylov solvers against the JAX package on the CPU, in float64:
``equilibrate``/``equilibrate_3d``, ``deff_flux_average``, the shared PCG
loop through ``solve_cg*`` (all three criteria, a window cut by
``max_iter``, the divergence net), ``omega_opt`` and ``solve_rbsor*``,
``solve_cgir*`` and the 3D ``solve_cg_3d*``/``solve_rbsor_3d*``.

Both packages run the same schedules, so iteration counts are equal; the
sums run in another order, so fields agree to rounding: Deff rtol 1e-10
(cg), 1e-12 (rbsor), 1e-9 (cgir, whose inner solves are float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import flux as jflux
from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops import fvm3d as jfvm3d
from effectivediffusivityfvm_tpu.solvers import cg as jcg
from effectivediffusivityfvm_tpu.solvers import pcg as jpcg
from effectivediffusivityfvm_tpu.solvers import rbsor as jrbsor
from effectivediffusivityfvm_tpu.solvers import refine as jrefine
from effectivediffusivityfvm_tpu.solvers import solvers3d as js3
from effectivediffusivityfvm_tpu_torch.ops import flux, fvm, fvm3d
from effectivediffusivityfvm_tpu_torch.solvers import (cg, dispatch, pcg,
                                                       rbsor, refine,
                                                       solvers3d)

# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)
F64 = torch.float64


def _to_jax(tree):
    return type(tree)(*(jnp.asarray(a.numpy()) for a in tree))


def _d_field(seed, shape, decades=2.0):
    """Log-uniform D over ``decades`` decades."""
    rng = np.random.default_rng(seed)
    return 10.0 ** (-decades * rng.random(shape))


def _system2(seed, shape):
    """Port and JAX views of one 2D system ``(coeffs, spec, x0)``; a leading
    batch dim in ``shape`` gives a batch."""
    d = torch.tensor(_d_field(seed, shape))
    c = fvm.fvm_coefficients(d, 0.0, 1.0)
    s = flux.make_flux_spec(d, 0.0, 1.0)
    nx = shape[-1]
    x0 = (torch.arange(nx, dtype=F64) / nx).expand(shape).contiguous()
    return (c, s, x0), (_to_jax(c), _to_jax(s), jnp.asarray(x0.numpy()))


def _system3(seed, shape):
    d = torch.tensor(_d_field(seed, shape))
    c = fvm3d.fvm_coefficients_3d(d, 0.0, 1.0)
    s = fvm3d.make_flux_spec_3d(d, 0.0, 1.0)
    nx = shape[-1]
    x0 = (torch.arange(nx, dtype=F64) / nx).expand(shape).contiguous()
    return (c, s, x0), (_to_jax(c), _to_jax(s), jnp.asarray(x0.numpy()))


def _same(got, ref, rtol, conv_atol):
    """Equal iteration counts, Deff to ``rtol``, the monitor to
    ``conv_atol`` (at the stop it is rounding noise below the tolerance)."""
    np.testing.assert_array_equal(np.asarray(got.iters), np.asarray(ref.iters))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=rtol)
    np.testing.assert_allclose(got.conv.numpy(), np.asarray(ref.conv),
                               rtol=1e-9, atol=conv_atol)


# ------------------------------------------------------------ operators


@pytest.mark.parametrize("ndim", [2, 3])
def test_equilibrate_matches_jax(ndim):
    if ndim == 2:
        (c, _, _), (jc, _, _) = _system2(1, (2, 12, 14))
        got, s = fvm.equilibrate(c)
        ref, js = jfvm.equilibrate(jc)
    else:
        (c, _, _), (jc, _, _) = _system3(1, (6, 8, 10))
        got, s = fvm3d.equilibrate_3d(c)
        ref, js = jfvm3d.equilibrate_3d(jc)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-14)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14)


def test_deff_flux_average_matches_jax():
    rng = np.random.default_rng(4)
    d = _d_field(4, (2, 10, 16))
    x = rng.random((2, 10, 16))
    for k in range(2):          # one image, as the JAX function takes it
        ref = jflux.deff_flux_average(jnp.asarray(d[k]), jnp.asarray(x[k]),
                                      0.25, 1.0)
        got = flux.deff_flux_average(torch.tensor(d[k]), torch.tensor(x[k]),
                                     0.25, 1.0)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-13)
    both = flux.deff_flux_average(torch.tensor(d), torch.tensor(x), 0.25, 1.0)
    assert both.shape == (2,)
    assert float(both[1]) == float(flux.deff_flux_average(
        torch.tensor(d[1]), torch.tensor(x[1]), 0.25, 1.0))


# ------------------------------------------------------------ cg / run_pcg


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("criterion,tol,max_iter", [
    ("residual", 1e-11, 5000), ("relresidual", 1e-11, 5000),
    ("deff", 1e-9, 5000),
    # windows 1, 20, 20 and a cut one of 9: the last window checks nothing
    ("relresidual", 1e-15, 50)])
def test_solve_cg_matches_jax(batched, criterion, tol, max_iter):
    shape = (3, 20, 24) if batched else (20, 24)
    (c, s, x0), (jc, js, jx0) = _system2(7, shape)
    kw = dict(tol=tol, max_iter=max_iter, check_every=20, criterion=criterion)
    fn, jfn = ((cg.solve_cg_batched, jcg.solve_cg_batched) if batched
               else (cg.solve_cg, jcg.solve_cg))
    got = fn(c, s, x0, **kw)
    ref = jfn(jc, js, jx0, **kw)
    _same(got, ref, 1e-10, 1e-2 * tol)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-12)
    if max_iter == 50:
        assert np.all(got.iters.numpy() == 50)
        # the cut window moved x after the last check: conv is the check's
        last_check = fn(c, s, x0, **dict(kw, max_iter=41))
        np.testing.assert_array_equal(got.conv.numpy(),
                                      last_check.conv.numpy())
        assert not torch.equal(got.x, last_check.x)
    else:
        assert np.all(got.conv.numpy() <= tol)
        if batched:
            assert len(set(got.iters.tolist())) > 1     # images froze apart


def _blow_up(batched):
    """``A = diag(dv)``: image 0 the identity; image 1 indefinite with a
    first ``<p, A p>`` of ~1e-9 |p|^2, so the first step overshoots by ~1e9
    and the first check finds the residual far above the best."""
    n = 8
    dv = np.ones((2, n, n))
    dv[1, :, : n // 2] = -(1.0 - 1e-9)
    b = np.ones((2, n, n))
    if not batched:
        dv, b = dv[1], b[1]
    return dv, b


@pytest.mark.parametrize("batched", [False, True])
def test_divergence_net_returns_best_iterate(batched):
    dv, b = _blow_up(batched)
    kw = dict(tol=1e-12, max_iter=100, check_every=5, criterion="residual",
              grid_ndim=2, batched=batched)
    ref = jpcg.run_pcg(lambda p: jnp.asarray(dv) * p, lambda r: r,
                       jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                       lambda x: jnp.sum(x, axis=(-2, -1)), **kw)
    tdv = torch.tensor(dv)
    got = pcg.run_pcg(lambda p: tdv * p, lambda r, active=None: r,
                      torch.tensor(b), torch.zeros(b.shape, dtype=F64),
                      lambda x: torch.sum(x, dim=(-2, -1)), **kw)
    _same(got, ref, 1e-12, 1e-14)
    bad = got.x[1] if batched else got.x
    assert float(bad.abs().max()) == 0.0        # x_best: the start
    conv = got.conv[1] if batched else got.conv
    assert float(conv) == 1.0                   # the best residual, mean|b|
    assert int(got.iters[1] if batched else got.iters) == 1
    if batched:
        assert float(got.conv[0]) <= 1e-12      # the healthy image solved


# ------------------------------------------------------------ rbsor


@pytest.mark.parametrize("shape", [(16, 16), (9, 30), (1, 2)])
def test_omega_opt_matches_jax(shape):
    assert rbsor.omega_opt(*shape) == jrbsor.omega_opt(*shape)


@pytest.mark.parametrize("batched,criterion", [
    (False, "deff"), (False, "relresidual"), (True, "deff")])
def test_solve_rbsor_matches_jax(batched, criterion):
    shape = (3, 16, 20) if batched else (16, 20)
    (c, s, x0), (jc, js, jx0) = _system2(3, shape)
    kw = dict(tol=1e-10, max_iter=20_000, check_every=25,
              criterion=criterion)
    fn, jfn = ((rbsor.solve_rbsor_batched, jrbsor.solve_rbsor_batched)
               if batched else (rbsor.solve_rbsor, jrbsor.solve_rbsor))
    got = fn(c, s, x0, **kw)
    ref = jfn(jc, js, jx0, **kw)
    _same(got, ref, 1e-12, 1e-12)
    assert np.all(got.iters.numpy() < 20_000)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-11)


# ------------------------------------------------------------ cgir


@pytest.mark.parametrize("batched", [False, True])
def test_solve_cgir_matches_jax(batched):
    shape = (2, 16, 16) if batched else (16, 16)
    (c, s, x0), (jc, js, jx0) = _system2(5, shape)
    fn, jfn = ((refine.solve_cgir_batched, jrefine.solve_cgir_batched)
               if batched else (refine.solve_cgir, jrefine.solve_cgir))
    got = fn(c, s, x0, tol=1e-10)
    ref = jfn(jc, js, jx0, tol=1e-10)
    np.testing.assert_array_equal(np.asarray(got.iters), np.asarray(ref.iters))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=1e-9)
    assert np.all(got.conv.numpy() <= 1e-10)
    assert np.all(got.iters.numpy() >= 2)          # refinement did work
    via = dispatch.solve_batched if batched else dispatch.solve
    again = via("cgir", c, s, x0, tol=1e-10, omega=0.0, check_every=0,
                criterion="relresidual")
    assert torch.equal(again.x, got.x)


def test_cgir_needs_f64():
    (c, s, x0), _ = _system2(5, (2, 8, 8))
    c32 = fvm.StencilCoeffs(*(a.float() for a in c))
    with pytest.raises(ValueError, match="f64"):
        refine.solve_cgir(fvm.StencilCoeffs(*(a[0] for a in c32)), s,
                          x0[0].float())
    with pytest.raises(ValueError, match="f64"):
        refine.solve_cgir_batched(c32, s, x0.float())


# ------------------------------------------------------------ 3D


@pytest.mark.parametrize("solver,batched", [
    ("cg", False), ("cg", True), ("rbsor", False), ("rbsor", True)])
def test_3d_cg_and_rbsor_match_jax(solver, batched):
    shape = (2, 8, 8, 10) if batched else (8, 8, 10)
    (c, s, x0), (jc, js, jx0) = _system3(9, shape)
    name = f"solve_{solver}_3d" + ("_batched" if batched else "")
    if solver == "cg":
        kw = dict(tol=1e-11, max_iter=2000, check_every=10,
                  criterion="relresidual")
    else:
        kw = dict(tol=1e-10, max_iter=5000, check_every=20,
                  criterion="deff")
    got = getattr(solvers3d, name)(c, s, x0, **kw)
    ref = getattr(js3, name)(jc, js, jx0, **kw)
    _same(got, ref, 1e-10 if solver == "cg" else 1e-12, 1e-2 * kw["tol"])
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-12)
