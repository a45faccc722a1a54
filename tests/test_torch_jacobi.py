"""The port's Jacobi path against the JAX package on the CPU, in float64:
K3's plain version against ``jacobi_sweeps_pallas`` in interpret mode, and
the four Jacobi solvers and the segmented ``run_single`` against their JAX
counterparts.

Both sides compute the same sums in the same order, so sweep results agree
to rounding (atol 1e-15, rtol 1e-13); the solvers follow the same schedule,
so iteration counts must be identical (Deff rtol 1e-10, x atol 1e-13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import BoundaryFluxSpec as JSpec
from effectivediffusivityfvm_tpu.ops.kernels.jacobi_vmem import \
    jacobi_sweeps_pallas
from effectivediffusivityfvm_tpu.solvers import driver as jdriver
from effectivediffusivityfvm_tpu.solvers import jacobi as jjacobi
from effectivediffusivityfvm_tpu.solvers import \
    jacobi_pallas as jjacobi_pallas
from effectivediffusivityfvm_tpu_torch.models import floodfill, phases
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.ops.kernels import jacobi as k3
from effectivediffusivityfvm_tpu_torch.ops.kernels.jacobi import (
    jacobi_resident_fits, jacobi_sweeps, jacobi_sweeps_reference,
    resident_cluster)
from effectivediffusivityfvm_tpu_torch.solvers import driver, jacobi
from effectivediffusivityfvm_tpu_torch.solvers import jacobi_pallas

# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)

SOLVE_KW = dict(tol=1e-6, max_iter=20_000, check_every=50)


def _two_phase(rng, bsz, ny, nx):
    """Random 2-phase media, fluid D = 1, solid D = 1e-3."""
    imgs = np.where(rng.random((bsz, ny, nx)) < 0.35, 255, 0).astype(np.uint8)
    d = phases.d_field_from_classes(phases.two_phase_classes(imgs), 1.0, 1e-3,
                                    dtype=np.float64)
    return fvm.fvm_coefficients(torch.tensor(d), 0.0, 1.0)


def _three_phase(rng, bsz, ny, nx):
    """Random 3-phase media with solid and isolated pores masked, symmetric
    assembly (what ``needs_spd`` routes ``jacobi_pallas`` to)."""
    d, mask = [], []
    for _ in range(bsz):
        img = np.full((ny, nx), 150, np.uint8)
        img[rng.random((ny, nx)) < 0.25] = 255
        img[rng.random((ny, nx)) < 0.2] = 0
        img[:, 0] = img[:, -1] = 150
        ff = floodfill.flood_fill(img > 200)
        d.append(phases.d_field_from_classes(phases.three_phase_classes(img),
                                             1.0, 0.0, 30.0, dtype=np.float64))
        mask.append((img > 200) | ff.isolated)
    return fvm.fvm_coefficients(torch.tensor(np.stack(d)), 0.0, 1.0,
                                mask=torch.tensor(np.stack(mask)),
                                symmetric=True)


def _x0(rng, bsz, ny, nx):
    return np.linspace(0, 1, nx)[None, None, :] + 0.1 * rng.random((bsz, ny, nx))


@pytest.mark.parametrize("k", [0, 1, 7])
@pytest.mark.parametrize("system", [_two_phase, _three_phase])
@pytest.mark.parametrize("shape", [(16, 24), (24, 20)])
def test_sweeps_reference_matches_pallas_kernel(shape, system, k):
    rng = np.random.default_rng(11)
    c = system(rng, 3, *shape)
    x0 = _x0(rng, 3, *shape)
    cj = jfvm.StencilCoeffs(*(jnp.asarray(a.numpy()) for a in c))
    ref = np.asarray(jacobi_sweeps_pallas(cj, jnp.asarray(x0), k,
                                          interpret=True))
    x = torch.tensor(x0)
    got = jacobi_sweeps_reference(c, x, k)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-15)
    # the wrapper takes the plain version on a CPU tensor
    assert torch.equal(jacobi_sweeps(c, x, k), got)
    # image 1 frozen: bitwise unchanged, the others as before
    active = torch.tensor([1, 0, 1], dtype=torch.int32)
    frozen = jacobi_sweeps(c, x, k, active=active)
    assert torch.equal(frozen[1], x[1])
    assert torch.equal(frozen[0::2], got[0::2])
    assert x.data_ptr() != frozen.data_ptr()


@pytest.mark.parametrize("shape,itemsize,cluster", [
    ((128, 128), 4, 8),       # the CLI datagen batch (float32)
    ((128, 128), 8, 8),       # BASELINE config 1 (float64)
    ((129, 129), 8, 0),
    ((96, 160), 4, 4),
    ((96, 160), 8, 8),
    ((24, 20), 4, 1),
    ((170, 170), 4, 8),       # the largest float32 square the rule holds
    ((171, 171), 4, 0),
    ((512, 512), 4, 0),       # streams
    ((512, 512), 8, 0),
])
def test_resident_size_rule(shape, itemsize, cluster):
    assert resident_cluster(*shape, itemsize) == cluster
    assert jacobi_resident_fits(*shape, itemsize) == (cluster > 0)


@pytest.mark.parametrize("shape,dtype,route", [
    ((128, 128), torch.float32, "resident"),
    ((128, 128), torch.float64, "resident"),
    ((512, 512), torch.float32, "streaming"),
])
def test_wrapper_takes_the_route_of_the_size_rule(monkeypatch, shape, dtype,
                                                  route):
    """The CUDA wrapper's route choice, reached without a card: the two
    launchers are stubbed and see the validated arguments."""
    calls = []
    for name in ("resident", "streaming"):
        monkeypatch.setattr(k3, f"_{name}",
                            lambda c, x, k, w, a, name=name:
                            calls.append((name, k, w, a)) or x)
    c = _two_phase(np.random.default_rng(0), 2, *shape)
    c = fvm.StencilCoeffs(*(a.to(dtype) for a in c))
    x = torch.zeros((2,) + shape, dtype=dtype)
    act = k3._checked(c, x, 7, torch.tensor([1.0, 0.0]))
    k3._launch(c, x, 7, 0.5, act)
    assert [cl[:3] for cl in calls] == [(route, 7, 0.5)]
    assert calls[0][3].tolist() == [1, 0]
    assert calls[0][3].dtype == torch.int32


def test_sweeps_reject_negative_k():
    rng = np.random.default_rng(1)
    c = _two_phase(rng, 1, 8, 8)
    with pytest.raises(ValueError):
        jacobi_sweeps(c, torch.zeros(1, 8, 8, dtype=torch.float64), -1)


def _problem(bsz=3, ny=16, nx=24):
    """tests/test_pallas_kernel.py's batch problem (log-uniform D, 1..100),
    assembled by the port and handed to JAX as numpy arrays."""
    rng = np.random.default_rng(42)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(100), (bsz, ny, nx))))
    c = fvm.fvm_coefficients(d, 0.0, 1.0)
    s = make_flux_spec(d, 0.0, 1.0)
    cj = jfvm.StencilCoeffs(*(jnp.asarray(a.numpy()) for a in c))
    sj = JSpec(*(jnp.asarray(a.numpy()) for a in s))
    x0 = np.broadcast_to(np.arange(nx, dtype=np.float64) / nx, (bsz, ny, nx))
    return cj, sj, x0, c, s


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=1e-10)
    np.testing.assert_allclose(got.conv.numpy(), np.asarray(ref.conv),
                               rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("name", ["jacobi", "jacobi_pallas"])
def test_batched_solvers_match_jax(name):
    cj, sj, x0, c, s = _problem()
    jax_fn = {"jacobi": jjacobi.solve_jacobi_batched,
              "jacobi_pallas": jjacobi_pallas.solve_jacobi_pallas_batched}[name]
    fn = {"jacobi": jacobi.solve_jacobi_batched,
          "jacobi_pallas": jacobi_pallas.solve_jacobi_pallas_batched}[name]
    ref = jax_fn(cj, sj, jnp.asarray(x0), **SOLVE_KW)
    got = fn(c, s, torch.tensor(x0), **SOLVE_KW)
    assert len(set(got.iters.tolist())) > 1     # images froze at their own count
    _assert_same(got, ref)


@pytest.mark.parametrize("name", ["jacobi", "jacobi_pallas"])
def test_single_solvers_match_jax(name):
    cj, sj, x0, c, s = _problem(bsz=1)
    jax_fn = {"jacobi": jjacobi.solve_jacobi,
              "jacobi_pallas": jjacobi_pallas.solve_jacobi_pallas}[name]
    fn = {"jacobi": jacobi.solve_jacobi,
          "jacobi_pallas": jacobi_pallas.solve_jacobi_pallas}[name]
    one = jax.tree.map(lambda a: a[0], (cj, sj))
    ref = jax_fn(*one, jnp.asarray(x0[0]), **SOLVE_KW)
    got = fn(fvm.StencilCoeffs(*(a[0] for a in c)),
             type(s)(*(a[0] for a in s)), torch.tensor(x0[0]), **SOLVE_KW)
    _assert_same(got, ref)


def test_segmented_run_single_matches_jax():
    """A run split at sweep 101 (a check boundary) and resumed with the
    ``it0``/``deff0``/``deff_old0`` carry, on both sides; the port's two
    segments together stop where its continuous run stops."""
    cj, sj, x0, c, s = _problem(bsz=1)
    cj, sj = jax.tree.map(lambda a: a[0], (cj, sj))
    c = fvm.StencilCoeffs(*(a[0] for a in c))
    s = type(s)(*(a[0] for a in s))
    kw = dict(SOLVE_KW, criterion="deff")

    def jsweep(x):
        return jfvm.jacobi_sweep(cj, x, 2.0 / 3.0)

    def sweeps(x, k):
        for _ in range(k):
            x = fvm.jacobi_sweep(c, x, 2.0 / 3.0)
        return x

    whole = jacobi.solve_jacobi(c, s, torch.tensor(x0[0]), **kw)
    ref1 = jdriver.run_single(jsweep, cj, sj, jnp.asarray(x0[0]),
                              **dict(kw, max_iter=101))
    got1 = driver.run_single(sweeps, c, s, torch.tensor(x0[0]),
                             **dict(kw, max_iter=101))
    _assert_same(got1, ref1)
    carry = dict(it0=101, deff0=float(got1.deff), deff_old0=float(got1.deff))
    ref2 = jdriver.run_single(jsweep, cj, sj, ref1.x, **kw, **carry)
    got2 = driver.run_single(sweeps, c, s, got1.x, **kw, **carry)
    _assert_same(got2, ref2)
    assert int(got1.iters) + int(got2.iters) == int(whole.iters)
    np.testing.assert_allclose(float(got2.deff), float(whole.deff), rtol=1e-10)


def test_unknown_criterion_raises():
    _, _, x0, c, s = _problem(bsz=1)
    with pytest.raises(ValueError):
        jacobi.solve_jacobi_batched(c, s, torch.tensor(x0), criterion="bogus")
