"""The port's differentiable Deff (``ops/autodiff.py``) against the JAX
package's, on the CPU in float64.

The JAX side is pinned to its fused "cgstep" engine in interpret mode
(``solver_kw={"use_pallas": "cgstep", "pallas_interpret": True}``): off a
TPU its automatic choice is the XLA engine, whose schedule differs and
whose CPU compile takes ~50 s.  The port's automatic choice in float64 is
"cgstep" (the plain versions of K1/K2 on the CPU), so both sides run the
same algorithm: the forward and adjoint iteration counts must be equal,
Deff equal to rtol 1e-10 and the gradient to 1e-8 of max|g| (solved to
relresidual 1e-12).  Also the port's counterparts of
``tests/test_autodiff.py`` (finite differences, the uniform medium, two
calls alike in place of jit), a batch, a chain rule, and the assembly's
own gradients against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.autodiff import \
    deff_and_grad as j_deff_and_grad
from effectivediffusivityfvm_tpu.ops.autodiff import \
    make_differentiable_deff as j_make
from effectivediffusivityfvm_tpu.ops.flux import boundary_deff as j_deff
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as j_spec
from effectivediffusivityfvm_tpu.solvers.multigrid import \
    solve_mgcg as j_solve
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.autodiff import (
    deff_and_grad, make_differentiable_deff)
from effectivediffusivityfvm_tpu_torch.ops.flux import (boundary_deff,
                                                        make_flux_spec)

torch.set_num_threads(1)

J_KW = {"use_pallas": "cgstep", "pallas_interpret": True}
OPTS = dict(tol=1e-12, max_iter=2000)


def _field(seed, shape=(12, 14), hi=30.0):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(0, np.log(hi), shape))


@pytest.fixture(scope="module")
def pair():
    """One 12x14 field and both packages' (value, grad) of it."""
    d = _field(42)
    f = make_differentiable_deff(**OPTS)
    dt = torch.tensor(d, requires_grad=True)
    val = f(dt)
    val.backward()
    jv, jg = j_deff_and_grad(jnp.asarray(d), solver_kw=J_KW, **OPTS)
    return (d, f, float(val.detach()), dt.grad.numpy(), float(jv),
            np.asarray(jg))


def test_value_and_gradient_match_jax(pair):
    _, _, val, grad, jv, jg = pair
    np.testing.assert_allclose(val, jv, rtol=1e-10)
    assert np.abs(grad - jg).max() <= 1e-8 * np.abs(jg).max()
    v2, g2 = deff_and_grad(torch.tensor(pair[0]), **OPTS)
    assert float(v2) == val
    np.testing.assert_array_equal(g2.numpy(), grad)


def test_forward_and_adjoint_iterations_match_jax(pair):
    """The adjoint's right-hand side lives in the two boundary columns only,
    so its relresidual scale is small; the solve must stop where the JAX
    adjoint solve stops."""
    d, f, *_ = pair
    kw = dict(check_every=10, criterion="relresidual", **OPTS, **J_KW)
    dj = jnp.asarray(d)
    c, s = jfvm.fvm_coefficients(dj, 0.0, 1.0), j_spec(dj, 0.0, 1.0)
    nx = d.shape[-1]
    x0 = jnp.broadcast_to(jnp.arange(nx, dtype=dj.dtype) / nx, d.shape)
    fwd = j_solve(c, s, x0, **kw)
    gx = jax.grad(lambda x: j_deff(s, x))(fwd.x)
    adj = j_solve(c._replace(b=gx), s, jnp.zeros_like(fwd.x), **kw)
    assert int(f.iterations["forward"]) == int(fwd.iters)
    assert int(f.iterations["adjoint"]) == int(adj.iters)
    assert int(adj.iters) > 1


def test_gradient_matches_finite_differences(pair):
    d, _, val, grad, *_ = pair
    assert np.isfinite(val) and val > 0
    f = make_differentiable_deff(**OPTS)
    eps = 1e-5
    for i, j in [(2, 3), (7, 9), (0, 0), (11, 13), (5, 0)]:
        dp, dm = d.copy(), d.copy()
        dp[i, j] += eps
        dm[i, j] -= eps
        fd = (float(f(torch.tensor(dp))) - float(f(torch.tensor(dm)))) / (
            2 * eps)
        an = float(grad[i, j])
        assert abs(fd - an) <= 1e-5 * max(abs(fd), abs(an), 1e-3), (
            (i, j), fd, an)


def test_gradient_of_uniform_medium_sums_to_one():
    # analytic: for uniform d, Deff == d, so dDeff/dd sums to 1
    val, grad = deff_and_grad(torch.full((10, 10), 2.5, dtype=torch.float64),
                              tol=1e-13, max_iter=2000)
    np.testing.assert_allclose(float(val), 2.5, rtol=1e-9)
    np.testing.assert_allclose(float(grad.sum()), 1.0, rtol=1e-6)


def test_two_calls_give_equal_gradients():
    """In place of JAX's jit-and-grad test: the callable is reusable and
    deterministic."""
    d = torch.tensor(_field(3, (8, 8), 10.0))
    f = make_differentiable_deff(tol=1e-10, max_iter=1000)
    grads = []
    for _ in range(2):
        dd = d.clone().requires_grad_()
        (g,) = torch.autograd.grad(f(dd), dd)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_batch_gradients_are_the_per_image_gradients():
    """A (B, ny, nx) field runs one batched forward and one batched adjoint
    solve; each image's value and gradient are its own (the counterpart
    of jax.vmap over the JAX callable)."""
    d = _field(5, (3, 12, 14))
    val, grad = deff_and_grad(torch.tensor(d), **OPTS)
    assert val.shape == (3,) and grad.shape == d.shape
    for b in range(3):
        v1, g1 = deff_and_grad(torch.tensor(d[b]), **OPTS)
        np.testing.assert_allclose(float(val[b]), float(v1), rtol=1e-12)
        assert (grad[b] - g1).abs().max() <= 1e-12 * g1.abs().max()
        jv, jg = j_deff_and_grad(jnp.asarray(d[b]), solver_kw=J_KW, **OPTS)
        np.testing.assert_allclose(float(val[b]), float(jv), rtol=1e-10)
        jg = np.asarray(jg)
        assert np.abs(grad[b].numpy() - jg).max() <= 1e-8 * np.abs(jg).max()


def test_chain_rule_through_log_diffusivity():
    """d = exp(theta): autograd carries the adjoint gradient on to theta,
    as jax.grad does through the JAX callable."""
    theta = np.log(_field(9, (12, 14), 20.0))
    f = make_differentiable_deff(**OPTS)
    t = torch.tensor(theta, requires_grad=True)
    f(torch.exp(t)).backward()
    jf = j_make(solver_kw=J_KW, **OPTS)
    jg = np.asarray(jax.grad(lambda x: jf(jnp.exp(x)))(jnp.asarray(theta)))
    assert np.abs(t.grad.numpy() - jg).max() <= 1e-8 * np.abs(jg).max()
    _, g = deff_and_grad(torch.exp(torch.tensor(theta)), **OPTS)
    torch.testing.assert_close(t.grad, g * torch.exp(torch.tensor(theta)),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("with_zeros", [False, True])
def test_assembly_gradients_match_jax(with_zeros):
    """Assembly and the flux keep their autograd graph back to d: the
    gradient of a functional of fvm_coefficients, apply_operator,
    make_flux_spec and boundary_deff equals JAX's wherever JAX's is
    finite, and is finite everywhere when d > 0."""
    rng = np.random.default_rng(11)
    d = _field(7, (6, 9), 50.0)
    if with_zeros:
        d[rng.random(d.shape) < 0.2] = 0.0
    x = rng.random(d.shape)
    w = rng.standard_normal((8,) + d.shape)

    def loss(c, op, deff, ws):
        terms = list(c) + [op]
        return sum((wk * t).sum() for wk, t in zip(ws, terms)) + deff

    def port(dd):
        c = fvm.fvm_coefficients(dd, 0.0, 1.0)
        xt = torch.tensor(x)
        return loss(c, fvm.apply_operator(c, xt),
                    boundary_deff(make_flux_spec(dd, 0.0, 1.0), xt),
                    torch.tensor(w))

    def jax_fn(dd):
        c = jfvm.fvm_coefficients(dd, 0.0, 1.0)
        return loss(c, jfvm.apply_operator(c, x),
                    j_deff(j_spec(dd, 0.0, 1.0), x), jnp.asarray(w))

    dt = torch.tensor(d, requires_grad=True)
    value = port(dt)
    value.backward()
    np.testing.assert_allclose(float(value.detach()),
                               float(jax_fn(jnp.asarray(d))), rtol=1e-12)
    jg = np.asarray(jax.grad(jax_fn)(jnp.asarray(d)))
    g = dt.grad.numpy()
    ok = np.isfinite(jg)
    if not with_zeros:
        assert ok.all() and np.isfinite(g).all()
    assert np.isfinite(g[ok]).all()
    np.testing.assert_allclose(g[ok], jg[ok], rtol=1e-12,
                               atol=1e-12 * np.abs(jg[ok]).max())


def test_engines_left_out_raise():
    """The plain engine (``use_pallas=False``), refused before it was
    ported, gives the fused engine's Deff and gradient (against the JAX
    package: tests/test_torch_general_cycle.py)."""
    d = torch.tensor(_field(1, (8, 8)))
    value, grad = deff_and_grad(d, solver_kw={"use_pallas": False})
    ref_value, ref_grad = deff_and_grad(d)
    np.testing.assert_allclose(float(value), float(ref_value), rtol=1e-8)
    np.testing.assert_allclose(grad.numpy(), ref_grad.numpy(), rtol=1e-6,
                               atol=1e-6 * float(ref_grad.abs().max()))
