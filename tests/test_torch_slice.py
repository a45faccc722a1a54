"""The port's batched MGCG solve against the JAX package's fused "cgstep"
engine (Pallas kernels in interpret mode), on the CPU in float64.

JAX is pinned to ``use_pallas="cgstep"``: off the TPU its automatic choice
is the XLA engine, whose check schedule and iteration counts differ.  The
settings are the bench's (bench.py) scaled down to 16x24 / 32x32 grids.
Both sides run the same algorithm with the same schedule, so iteration
counts must be identical; the remaining differences are summation order
in the dot products (Deff rtol 1e-9, x rtol 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from effectivediffusivityfvm_tpu.models import phases as jphases
from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as j_spec
from effectivediffusivityfvm_tpu.solvers.multigrid import \
    solve_mgcg_batched as j_solve
from effectivediffusivityfvm_tpu_torch.models import phases
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.solvers.multigrid import (
    solve_mgcg, solve_mgcg_batched)

BENCH_KW = dict(max_iter=3000, check_every=10, first_window=10,
                criterion="residual", min_size=4, coarse_iters=8, nu1=2,
                nu2=2, over=1.8, mg_omega=(1.281, 0.5584))
# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)


def _lognormal(seed, bsz=3, ny=16, nx=24, contrast=1e4):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(0, np.log(contrast), (bsz, ny, nx)))


def _bench_medium(bsz, n, contrast=1e-6, porosity=0.65):
    """bench.py's generator: smoothed noise thresholded at the porosity
    quantile, fluid D = 1, solid D = contrast."""
    rng = np.random.default_rng(7)
    imgs = []
    for _ in range(bsz):
        noise = ndimage.gaussian_filter(rng.standard_normal((n, n)), sigma=4.0)
        imgs.append(((noise >= np.quantile(noise, porosity)) * 255)
                    .astype(np.uint8))
    classes = np.stack([jphases.two_phase_classes(im) for im in imgs])
    return jphases.d_field_from_classes(classes, 1.0, contrast,
                                        dtype=np.float64)


def _solve_both(d, **kw):
    bsz, ny, nx = d.shape
    dj = jnp.asarray(d)
    cj = jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(dj, 0.0, 1.0)
    sj = jax.vmap(j_spec, in_axes=(0, None, None))(dj, 0.0, 1.0)
    x0 = np.broadcast_to(np.arange(nx) / nx, (bsz, ny, nx))
    ref = j_solve(cj, sj, jnp.asarray(x0), use_pallas="cgstep",
                  pallas_interpret=True, **kw)
    dt = torch.tensor(d)
    got = solve_mgcg_batched(fvm.fvm_coefficients(dt, 0.0, 1.0),
                             make_flux_spec(dt, 0.0, 1.0),
                             torch.tensor(x0), **kw)
    return ([np.asarray(a) for a in ref], [a.numpy() for a in got])


CASES = {
    "lognormal": (lambda: _lognormal(1), dict(BENCH_KW, tol=1e-9)),
    "truncated_max_iter_7": (lambda: _lognormal(1),
                             dict(BENCH_KW, tol=1e-9, max_iter=7)),
    "bench_medium_32": (lambda: _bench_medium(2, 32),
                        dict(BENCH_KW, tol=1e-6)),
    "deff_criterion_auto_window": (
        lambda: _lognormal(2), dict(BENCH_KW, tol=1e-6, criterion="deff",
                                    first_window=0)),
    "relresidual_criterion": (
        lambda: _lognormal(6), dict(BENCH_KW, tol=1e-9,
                                    criterion="relresidual")),
}


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    make, kw = CASES[request.param]
    return request.param, kw, _solve_both(make(), **kw)


def test_solve_matches_jax_fused_engine(solved):
    name, kw, (ref, got) = solved
    x_r, deff_r, conv_r, it_r = ref
    x_g, deff_g, conv_g, it_g = got
    np.testing.assert_array_equal(it_g, it_r)
    np.testing.assert_allclose(deff_g, deff_r, rtol=1e-9)
    np.testing.assert_allclose(x_g, x_r, rtol=1e-7, atol=1e-12)
    if name.startswith("truncated"):
        assert np.all(it_g == 7)
        np.testing.assert_allclose(conv_g, conv_r, rtol=1e-9)
        assert np.all(conv_g < 1.0)          # checked, not the sentinel
    else:
        assert np.all(np.abs(conv_g) <= kw["tol"])


def test_bench_medium_phases_match():
    rng = np.random.default_rng(7)
    noise = ndimage.gaussian_filter(rng.standard_normal((32, 32)), sigma=4.0)
    img = ((noise >= np.quantile(noise, 0.65)) * 255).astype(np.uint8)
    cls = phases.two_phase_classes(img)
    np.testing.assert_array_equal(cls, jphases.two_phase_classes(img))
    assert abs(phases.porosity(img) - 0.65) < 0.01


def test_single_image_solve_matches_batched():
    d = _lognormal(3, bsz=2)
    dt = torch.tensor(d)
    c = fvm.fvm_coefficients(dt, 0.0, 1.0)
    s = make_flux_spec(dt, 0.0, 1.0)
    x0 = torch.arange(24, dtype=torch.float64).div(24).expand(2, 16, 24)
    kw = dict(BENCH_KW, tol=1e-9)
    batched = solve_mgcg_batched(c, s, x0, **kw)
    for i in range(2):
        solo = solve_mgcg(fvm.StencilCoeffs(*(a[i] for a in c)),
                          type(s)(*(a[i] for a in s)), x0[i], **kw)
        assert int(solo.iters) == int(batched.iters[i])
        torch.testing.assert_close(solo.deff, batched.deff[i], rtol=1e-12,
                                   atol=0)
        assert solo.x.shape == (16, 24)


def test_solve_rejects_unequal_smoothing():
    """The fused engines, forced, implement V(nu, nu) only; auto sends
    V(1, 2) to the plain cycle under run_pcg, which converges."""
    d = torch.tensor(_lognormal(4, bsz=1))
    args = (fvm.fvm_coefficients(d, 0.0, 1.0), make_flux_spec(d, 0.0, 1.0),
            d)
    for engine in ("cgstep", "tiled"):
        with pytest.raises(ValueError, match="V\\(nu, nu\\)"):
            solve_mgcg_batched(*args, nu1=1, nu2=2, use_pallas=engine)
    res = solve_mgcg_batched(*args, nu1=1, nu2=2, tol=1e-8)
    assert float(res.conv) <= 1e-8


def test_solve_does_not_modify_x0():
    d = torch.tensor(_lognormal(5, bsz=2))
    x0 = torch.rand(2, 16, 24, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    keep = x0.clone()
    solve_mgcg_batched(fvm.fvm_coefficients(d, 0.0, 1.0),
                       make_flux_spec(d, 0.0, 1.0), x0,
                       **dict(BENCH_KW, tol=1e-6))
    assert torch.equal(x0, keep)
