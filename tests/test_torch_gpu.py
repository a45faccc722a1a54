"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips when no
CUDA device is present, so on a CPU-only machine they all skip.  They import
no JAX, so where JAX is not installed run them without the JAX-side
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

float64 runs the kernels' double instantiation.  The kernels are built
without FMA contraction and follow their plain versions operation for
operation, so the only differences left are the order of the (double)
reductions: 1e-9 of max-abs in float64, and chip_smoke.py's 1e-4 in
float32.  K3 (the Jacobi sweeps), K4 (the banded cycle) and K6 (the 3D
cycles) have no reductions and must match exactly.  K5 and K7 sum float32
products in double and round once, so in float32 they must match exactly
too; in float64 the products themselves are double and the order of their
sums shows in the last bits.
"""

import ctypes

import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu_torch.ops import fvm, fvm3d
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.ops.kernels import _build
from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle3d as v3
from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle_tiled as vt
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
    cg_steps, cg_steps_reference)
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep3d import (
    PASSES, cg_steps3d, cg_steps3d_reference, march3_plan)
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import (
    cg_steps_tiled, cg_steps_tiled_reference)
from effectivediffusivityfvm_tpu_torch.ops.kernels.jacobi import (
    jacobi_resident_fits, jacobi_sweeps, jacobi_sweeps_reference)
from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import (
    LevelArgs, cycle_launches, cycle_resident_from, v_cycle,
    v_cycle_reference)
from effectivediffusivityfvm_tpu_torch.models import phases
from effectivediffusivityfvm_tpu_torch.solvers import (deflation, dmg,
                                                       multigrid, rbsor,
                                                       solvers3d)

pytestmark = pytest.mark.gpu

MG = dict(omega=(1.281, 0.5584), nu=2, coarse_iters=8, over=1.8)
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(dev, dtype, bsz, ny, nx, seed=0, contrast=1e4):
    rng = np.random.default_rng(seed)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(contrast), (bsz, ny, nx))),
                     dtype=dtype, device=dev)
    c = fvm.fvm_coefficients(d, 0.0, 1.0)
    levels = multigrid.build_hierarchy(c, min_size=4, pad_levels=True)
    py, px = levels[0].diag.shape[-2:]
    x = torch.zeros((bsz, py, px), dtype=dtype, device=dev)
    x[:, :ny, :nx] = torch.arange(nx, dtype=dtype, device=dev).div(nx)
    return d, c, levels, x


def _rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(16, 24), (15, 23), (64, 64), (40, 97)])
def test_v_cycle_kernel_matches_plain(cuda, dtype, shape):
    _, _, levels, x = _problem(cuda, dtype, 3, *shape)
    r = levels[0].b - fvm.apply_operator(levels[0], x)
    before = v_cycle.launches
    z = v_cycle(levels, r, **MG)
    torch.cuda.synchronize()
    assert v_cycle.launches == before + 1
    assert _rel_err(z, v_cycle_reference(levels, r, **MG)) <= TOL[dtype]


SCHEDULES = {1: (0.8,), 2: (1.281, 0.5584), 3: (1.2, 0.7, 0.9),
             4: (1.3, 0.6, 0.9, 0.75),
             6: (1.3, 0.6, 0.9, 0.75, 1.1, 0.7)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nu", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,min_size,resident_from", [
    ((40, 52), 4, {4: 0, 8: 0}),        # the whole pyramid resident
    ((130, 70), 4, {4: 1, 8: 1}),       # level 0 in tile passes, partial tiles
    ((300, 260), 8, {4: 2, 8: 3}),      # padded coarse levels in passes
    ((160, 144), 200, {4: 1, 8: 1}),    # one level, too large for one CTA
])
def test_v_cycle_kernel_bit_equal_across_the_resident_rule(
        cuda, dtype, nu, shape, min_size, resident_from):
    """K2 equals its plain version bit for bit for nu = 1..4 on both sides of
    the resident rule, with a gated image, in the launches the rule gives:
    two tile passes a level above the bottom and one launch for the rest."""
    rng = np.random.default_rng(nu)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(1e4), (3,) + shape)),
                     dtype=dtype, device=cuda)
    levels = multigrid.build_hierarchy(fvm.fvm_coefficients(d, 0.0, 1.0),
                                       min_size=min_size, pad_levels=True)
    shapes = [tuple(c.diag.shape[-2:]) for c in levels]
    item = d.element_size()
    lb = cycle_resident_from(shapes, item)
    assert lb == resident_from[item]
    la = LevelArgs(levels, d)
    lib = _build.load_library()
    assert lib.deff_cycle_resident_from(len(shapes), la.ny, la.nx, item) == lb
    r = torch.tensor(rng.standard_normal((3,) + shapes[0]), dtype=dtype,
                     device=cuda)
    active = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    mg = dict(omega=SCHEDULES[nu], nu=nu, coarse_iters=5, over=1.8,
              active=active)
    n0 = lib.deff_launch_count()
    z = v_cycle(levels, r, **mg)
    torch.cuda.synchronize()
    assert lib.deff_launch_count() - n0 == cycle_launches(shapes, item)
    ref = v_cycle_reference(levels, r, **mg)
    assert torch.equal(z, ref), float((z - ref).abs().max())
    assert not bool(z[1].any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_steps_kernel_matches_plain(cuda, dtype):
    """Image 0 runs the window, 1 is frozen, 2 exits at iteration 0 on its
    stop, 3 overshoots (rz inflated) and trips its hi after one step."""
    _, _, levels, x = _problem(cuda, dtype, 4, 48, 40, seed=1)
    r = levels[0].b - fvm.apply_operator(levels[0], x)
    p = v_cycle_reference(levels, r, **MG)
    rz = torch.sum(r * p, dim=(-2, -1))
    sr0 = torch.sum(r.abs(), dim=(-2, -1))
    rz[3] *= 1e3
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=dtype, device=cuda)
    stop = torch.zeros_like(sr0)
    stop[2] = 10 * sr0[2]
    hi = torch.full_like(sr0, float("inf"))
    hi[3] = 2 * sr0[3]
    state = (x, r, p, rz, active, stop, hi)
    got = cg_steps(levels, *(t.clone() for t in state), 4, **MG)
    ref = cg_steps_reference(levels, *(t.clone() for t in state), 4, **MG)
    torch.cuda.synchronize()
    assert got[4].tolist() == ref[4].tolist() == [4, 0, 0, 1]
    for g, e in zip(got[:3], ref[:3]):
        for b in range(4):
            assert _rel_err(g[b], e[b]) <= TOL[dtype]
    for g, e in zip(got[3::2], ref[3::2]):
        torch.testing.assert_close(g, e, rtol=10 * TOL[dtype], atol=0)
    for g, s in zip(got[:4], state[:4]):
        assert torch.equal(g[1], s[1])          # frozen: bit-unchanged
    assert float(got[5][1]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nu,shape,min_size", [
    (1, (48, 40), 4),        # V(1,1): one fused sweep each side
    (3, (48, 40), 4),        # nu > 2: K2's level kernels for the middle
    (2, (130, 70), 4),       # partial 64x16 tiles, padded levels
    (2, (6, 8), 8),          # a one-level hierarchy
])
def test_cg_steps_kernel_cycle_forms(cuda, dtype, nu, shape, min_size):
    """K1's pass structure for every cycle it takes: the same frozen, exit
    and tripped images as above, on a batch of 4."""
    d, c, _, x = _problem(cuda, dtype, 4, *shape, seed=5)
    levels = multigrid.build_hierarchy(c, min_size=min_size, pad_levels=True)
    x = torch.zeros((4,) + tuple(levels[0].diag.shape[-2:]), dtype=dtype,
                    device=cuda)
    x[:, :shape[0], :shape[1]] = torch.arange(
        shape[1], dtype=dtype, device=cuda).div(shape[1])
    mg = dict(MG, nu=nu, omega=0.8)
    r = levels[0].b - fvm.apply_operator(levels[0], x)
    p = v_cycle_reference(levels, r, **mg)
    rz = torch.sum(r * p, dim=(-2, -1))
    sr0 = torch.sum(r.abs(), dim=(-2, -1))
    rz[3] *= 1e3
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=dtype, device=cuda)
    stop = torch.zeros_like(sr0)
    stop[2] = 10 * sr0[2]
    hi = torch.full_like(sr0, float("inf"))
    hi[3] = 2 * sr0[3]
    state = (x, r, p, rz, active, stop, hi)
    got = cg_steps(levels, *(t.clone() for t in state), 3, **mg)
    ref = cg_steps_reference(levels, *(t.clone() for t in state), 3, **mg)
    torch.cuda.synchronize()
    assert (len(levels) == 1) == (min_size == 8)
    assert got[4].tolist() == ref[4].tolist() == [3, 0, 0, 1]
    for g, e in zip(got[:3], ref[:3]):
        for b in range(4):
            assert _rel_err(g[b], e[b]) <= TOL[dtype]
    for g, s in zip(got[:4], state[:4]):
        assert torch.equal(g[1], s[1])          # frozen: bit-unchanged


@pytest.mark.parametrize("use_pallas", [True, "tiledcycle"])
def test_cycle_only_engines_match_plain(cuda, use_pallas):
    """The cycle-only PCG on K2 and on K4 against the same solves on the
    kernels' plain versions (``plain=True``), float32: iterations within
    2, Deff rtol 1e-6; and the plain torch engine on the card against its
    run on the CPU (float64, the same iterations)."""
    d, c, _, _ = _problem(cuda, torch.float32, 3, 64, 72, seed=3)
    spec = make_flux_spec(d, 0.0, 1.0)
    x0 = torch.arange(72, dtype=torch.float32, device=cuda).div(72)
    x0 = x0.expand(3, 64, 72)
    kw = dict(tol=1e-5, max_iter=300, check_every=10, nu1=2, nu2=2,
              criterion="relresidual", min_size=4, coarse_iters=8,
              use_pallas=use_pallas)
    n0 = (v_cycle if use_pallas is True else vt.v_cycle_tiled).launches
    got = multigrid.solve_mgcg_batched(c, spec, x0, **kw)
    assert (v_cycle if use_pallas is True
            else vt.v_cycle_tiled).launches > n0
    ref = multigrid.solve_mgcg_batched(c, spec, x0, plain=True, **kw)
    assert (got.iters - ref.iters).abs().max() <= 2
    torch.testing.assert_close(got.deff, ref.deff, rtol=1e-6, atol=0)
    kw64 = dict(kw, use_pallas=False, tol=1e-9, nu2=1)
    c64 = fvm.StencilCoeffs(*(a.double() for a in c))
    s64 = type(spec)(*(a.double() for a in spec))
    on_card = multigrid.solve_mgcg_batched(c64, s64, x0.double(), **kw64)
    on_cpu = multigrid.solve_mgcg_batched(
        fvm.StencilCoeffs(*(a.cpu() for a in c64)),
        type(s64)(*(a.cpu() for a in s64)), x0.double().cpu(), **kw64)
    assert on_card.iters.cpu().tolist() == on_cpu.iters.tolist()
    torch.testing.assert_close(on_card.deff.cpu(), on_cpu.deff, rtol=1e-9,
                               atol=0)


def _dying_window(levels, r, p, dtype, dev, axes):
    """The CG state of a window in which every image dies early: image b
    stops once sum|r| falls to ``STOP[b]`` of its entry value."""
    rz = torch.sum(r * p, dim=axes)
    sr0 = torch.sum(r.abs(), dim=axes)
    bsz = r.shape[0]
    active = torch.ones(bsz, dtype=dtype, device=dev)
    stop = sr0 * torch.tensor([0.3, 0.02, 0.3][:bsz], dtype=dtype,
                              device=dev)
    hi = torch.full_like(sr0, float("inf"))
    return rz, active, stop, hi


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["K1", "K5", "K5-mf", "K7", "K7-mf"])
def test_cg_windows_leave_once_nothing_is_live(cuda, dtype, kernel):
    """K1, K5 and K7 on a k=12 window in which every image dies within a
    few iterations: the host loop launches at most WINDOW_LAG iterations
    past the last live one (deff_window_iter_count), and the results equal
    the plain version's, which leaves at the last live iteration."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import \
        WINDOW_LAG

    k = 12
    lib = _build.load_library()
    if kernel == "K1":
        _, _, levels, x = _problem(cuda, dtype, 3, 48, 40, seed=3)
        r = levels[0].b - fvm.apply_operator(levels[0], x)
        p = v_cycle_reference(levels, r, **MG)
        fn, ref_fn, extra, mg, axes = (cg_steps, cg_steps_reference, {}, MG,
                                       (-2, -1))
    elif kernel.startswith("K5"):
        levels, x, mf_kw = _tiled_problem(cuda, dtype, 3, 37, 300, seed=3)
        r = levels[0].b - fvm.apply_operator(levels[0], x)
        p = vt.v_cycle_tiled_reference(levels, r, **MG)
        fn, ref_fn, mg, axes = (cg_steps_tiled, cg_steps_tiled_reference, MG,
                                (-2, -1))
        extra = mf_kw if kernel.endswith("mf") else {}
    else:
        mg = dict(omega=SCHEDULES[2], nu=2, coarse_iters=8, over=1.8)
        _, _, levels, x, mf_kw = _problem3d(cuda, dtype, 3, *SHAPES_3D[0],
                                            seed=3)
        r = levels[0].b - fvm3d.apply_operator_3d(levels[0], x)
        p = v3.v_cycle3d_tiled_reference(levels, r, **mg)
        fn, ref_fn, axes = cg_steps3d, cg_steps3d_reference, (-3, -2, -1)
        extra = mf_kw if kernel.endswith("mf") else {}
    state = (x, r, p) + _dying_window(levels, r, p, dtype, cuda, axes)
    n0 = lib.deff_window_iter_count()
    got = fn(levels, *(t.clone() for t in state), k, **mg, **extra)
    torch.cuda.synchronize()
    launched = lib.deff_window_iter_count() - n0
    i0 = ref_fn.iterations
    ref = ref_fn(levels, *(t.clone() for t in state), k, **mg, **extra)
    ran = ref_fn.iterations - i0
    assert got[4].tolist() == ref[4].tolist()
    assert ran == int(ref[4].max()) < k
    assert ran <= launched <= ran + WINDOW_LAG
    for g, e in zip(got[:3], ref[:3]):
        for b in range(3):
            assert _rel_err(g[b], e[b]) <= TOL[dtype]


def test_solve_on_gpu_matches_plain_on_cpu(cuda):
    d, c, _, _ = _problem(cuda, torch.float64, 3, 32, 48, seed=2)
    spec = make_flux_spec(d, 0.0, 1.0)
    x0 = torch.arange(48, dtype=torch.float64, device=cuda).div(48)
    x0 = x0.expand(3, 32, 48)
    kw = dict(tol=1e-9, max_iter=500, check_every=10, first_window=10,
              nu1=2, nu2=2, mg_omega=MG["omega"], min_size=4, coarse_iters=8)
    got = multigrid.solve_mgcg_batched(c, spec, x0, **kw)
    ref = multigrid.solve_mgcg_batched(
        fvm.StencilCoeffs(*(a.cpu() for a in c)),
        type(spec)(*(a.cpu() for a in spec)), x0.cpu(), **kw)
    assert got.iters.cpu().tolist() == ref.iters.tolist()
    torch.testing.assert_close(got.deff.cpu(), ref.deff, rtol=1e-9, atol=0)


def test_wrappers_reject_bad_input(cuda):
    _, _, levels, x = _problem(cuda, torch.float32, 2, 16, 24)
    r = levels[0].b - fvm.apply_operator(levels[0], x)
    with pytest.raises(ValueError):
        v_cycle(levels, r.to(torch.float64), **MG)
    with pytest.raises(ValueError):
        v_cycle(levels, r[:, :, :-1], **MG)
    with pytest.raises(ValueError):
        v_cycle(levels, r.transpose(1, 2).contiguous().transpose(1, 2), **MG)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(24, 20), (96, 160), (33, 7)])
@pytest.mark.parametrize("k", [0, 1, 2, 9])
def test_jacobi_kernel_matches_plain(cuda, dtype, shape, k):
    """K3 equals its plain version bit for bit (same order of sums, no FMA
    contraction), on non-square grids and a batch of 5 that fills no
    tile; image 3 is frozen and comes back unchanged."""
    d, c, _, _ = _problem(cuda, dtype, 5, *shape, seed=3)
    x = torch.rand(d.shape, dtype=dtype, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(4))
    active = torch.tensor([1, 1, 1, 0, 1], dtype=torch.int32, device=cuda)
    lib = _build.load_library()
    before, n0 = jacobi_sweeps.launches, lib.deff_launch_count()
    res0 = jacobi_sweeps.resident_launches
    got = jacobi_sweeps(c, x, k, active=active)
    torch.cuda.synchronize()
    # every shape here takes the resident route: one launch per call
    assert jacobi_resident_fits(*shape, x.element_size())
    assert jacobi_sweeps.launches == before
    assert jacobi_sweeps.resident_launches - res0 == min(k, 1)
    assert lib.deff_launch_count() - n0 == min(k, 1)
    assert torch.equal(got, jacobi_sweeps_reference(c, x, k, active=active))
    assert torch.equal(got[3], x[3])
    assert got.data_ptr() != x.data_ptr()
    assert torch.equal(jacobi_sweeps(c, x, k), jacobi_sweeps_reference(c, x, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 37, 10_000])
def test_jacobi_routes_match_plain_at_128(cuda, dtype, k):
    """At the CLI batch's and config 1's 128^2, the resident route runs all
    k sweeps (10,000: a check window) in one launch, and it and the
    streaming route equal the plain version bit for bit; image 1 frozen."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels import jacobi as k3

    d, c, _, _ = _problem(cuda, dtype, 3, 128, 128, seed=6, contrast=1e6)
    x = torch.rand(d.shape, dtype=dtype, device=cuda,
                   generator=torch.Generator(cuda).manual_seed(7))
    active = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    lib = _build.load_library()
    n0, res0 = lib.deff_launch_count(), jacobi_sweeps.resident_launches
    got = jacobi_sweeps(c, x, k, active=active)
    torch.cuda.synchronize()
    assert lib.deff_launch_count() - n0 == 1
    assert jacobi_sweeps.resident_launches - res0 == 1
    ref = jacobi_sweeps_reference(c, x, k, active=active)
    assert torch.equal(got, ref)
    assert torch.equal(got[1], x[1])
    if k < 10_000:
        act = active.contiguous()
        streamed = k3._streaming(c, x, k, 2.0 / 3.0, act)
        torch.cuda.synchronize()
        assert lib.deff_launch_count() - n0 == 1 + k
        assert torch.equal(streamed, ref)


def test_jacobi_kernel_rejects_bad_input(cuda):
    _, c, _, _ = _problem(cuda, torch.float32, 2, 16, 24)
    x = torch.zeros((2, 16, 24), device=cuda)
    with pytest.raises(ValueError):
        jacobi_sweeps(c, x.to(torch.float64), 3)
    with pytest.raises(ValueError):
        jacobi_sweeps(c, x[:, :, :-1], 3)
    with pytest.raises(ValueError):
        jacobi_sweeps(c, x, -1)
    with pytest.raises(ValueError):
        jacobi_sweeps(c, x, 3, active=torch.ones(3, device=cuda))


def _tiled_problem(dev, dtype, bsz, ny, nx, seed=0, contrast=1e4):
    """The banded engine's padded hierarchy and x0, and its matrix-free
    arguments."""
    d, c, _, _ = _problem(dev, dtype, bsz, ny, nx, seed, contrast)
    levels, mf = multigrid.tiled_system(c, d, min_size=4)
    py, px = levels[0].diag.shape[-2:]
    x = torch.zeros((bsz, py, px), dtype=dtype, device=dev)
    x[:, :ny, :nx] = torch.arange(nx, dtype=dtype, device=dev).div(nx)
    return levels, x, mf


# (32, 24): one tile row, padded in x; (37, 300): padded on both axes;
# (100, 520): several tiles, the last row of tiles partial
TILED_SHAPES = [(32, 24), (37, 300), (100, 520)]
# K4's level passes tile level 0 in 60x28 tiles for nu <= 2 and 40x40 for
# nu = 3, 4 (levelpass2d.cuh): whole tile rows at 56 and 80 rows, one row
# past them at 57 (padded to 64), 240 columns (4 tiles of 60, padded to 256)
TILED_EDGES = [(56, 240), (80, 250), (57, 512)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nu", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", TILED_SHAPES + TILED_EDGES)
def test_v_cycle_tiled_kernel_matches_plain(cuda, dtype, nu, shape):
    """K4 (T1 and T2 as K2's level passes in the banded sweep form, K2's
    cycle from level 1 between them, one C entry) bit for bit, in 2 + the
    tail's launches."""
    levels, x, _ = _tiled_problem(cuda, dtype, 3, *shape)
    mg = dict(MG, omega=SCHEDULES[nu], nu=nu)
    r = levels[0].b - fvm.apply_operator(levels[0], x)
    shapes = [tuple(c.diag.shape[-2:]) for c in levels]
    lib = _build.load_library()
    before, k2, n0 = vt.v_cycle_tiled.launches, v_cycle.launches, \
        lib.deff_launch_count()
    z = vt.v_cycle_tiled(levels, r, **mg)
    torch.cuda.synchronize()
    assert vt.v_cycle_tiled.launches == before + 1
    assert v_cycle.launches == k2                     # the tail runs in C
    assert lib.deff_launch_count() - n0 == 2 + cycle_launches(
        shapes, r.element_size(), 1)
    ref = vt.v_cycle_tiled_reference(levels, r, **mg)
    assert torch.equal(z, ref), float((z - ref).abs().max())


def _check_cg_window(got, ref, state, dtype, exact_frozen):
    """K5/K7 against the plain version: image 0 ran the window, 1 was
    frozen, 2 exited at iteration 0, 3 tripped its hi after one step."""
    assert got[4].tolist() == ref[4].tolist() == [4, 0, 0, 1]
    if dtype == torch.float32:
        for g, e in zip(got[:4], ref[:4]):
            assert torch.equal(g, e), float((g - e).abs().max())
    else:
        for g, e in zip(got[:3], ref[:3]):
            for b in range(4):
                assert _rel_err(g[b], e[b]) <= TOL[dtype]
        torch.testing.assert_close(got[3], ref[3], rtol=10 * TOL[dtype],
                                   atol=0)
    for g, e in zip(got[:4], ref[:4]):
        assert torch.equal(g[1], e[1])          # frozen: as the plain version
    if exact_frozen:
        for g, s in zip(got[:4], state[:4]):
            assert torch.equal(g[1], s[1])      # stored: bit-unchanged


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mf", [False, True], ids=["stored", "matrix-free"])
@pytest.mark.parametrize("nu", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("shape", TILED_SHAPES)
def test_cg_steps_tiled_kernel_matches_plain(cuda, dtype, mf, nu, shape):
    """Image 0 runs the window, 1 is frozen, 2 exits at iteration 0 on its
    stop, 3 overshoots (rz inflated) and trips its hi after one step.  nu
    = 4 and 6 (the wrapper's largest) run the passes' deeper halos."""
    levels, x, mf_kw = _tiled_problem(cuda, dtype, 4, *shape, seed=1)
    mg = dict(MG, omega=SCHEDULES[nu], nu=nu)
    r = levels[0].b - fvm.apply_operator(levels[0], x)
    p = vt.v_cycle_tiled_reference(levels, r, **mg)
    rz = torch.sum(r * p, dim=(-2, -1))
    sr0 = torch.sum(r.abs(), dim=(-2, -1))
    rz[3] *= 1e3
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=dtype, device=cuda)
    stop = torch.zeros_like(sr0)
    stop[2] = 10 * sr0[2]
    hi = torch.full_like(sr0, float("inf"))
    hi[3] = 2 * sr0[3]
    extra = mf_kw if mf else {}
    state = (x, r, p, rz, active, stop, hi)
    before = cg_steps_tiled.launches
    got = cg_steps_tiled(levels, *(t.clone() for t in state), 4, **mg,
                         **extra)
    ref = cg_steps_tiled_reference(levels, *(t.clone() for t in state), 4,
                                   **mg, **extra)
    torch.cuda.synchronize()
    assert cg_steps_tiled.launches == before + 1
    _check_cg_window(got, ref, state, dtype, exact_frozen=not mf)


@pytest.mark.parametrize("mf", [False, True], ids=["stored", "matrix-free"])
def test_tiled_solve_on_gpu_matches_plain_on_cpu(cuda, mf):
    d, c, _, _ = _problem(cuda, torch.float64, 3, 40, 300, seed=2)
    spec = make_flux_spec(d, 0.0, 1.0)
    x0 = torch.arange(300, dtype=torch.float64, device=cuda).div(300)
    x0 = x0.expand(3, 40, 300)
    kw = dict(tol=1e-5, max_iter=200, check_every=10, first_window=1,
              criterion="relresidual", nu1=2, nu2=2, mg_omega=MG["omega"],
              min_size=4, coarse_iters=8, use_pallas="tiled")
    got = multigrid.solve_mgcg_batched(c, spec, x0, d_field=d if mf else None,
                                       **kw)
    ref = multigrid.solve_mgcg_batched(
        fvm.StencilCoeffs(*(a.cpu() for a in c)),
        type(spec)(*(a.cpu() for a in spec)), x0.cpu(),
        d_field=d.cpu() if mf else None, **kw)
    assert got.iters.cpu().tolist() == ref.iters.tolist()
    torch.testing.assert_close(got.deff.cpu(), ref.deff, rtol=1e-9, atol=0)


def _problem3d(dev, dtype, bsz, nz, ny, nx, seed=0, contrast=1e4):
    """The banded 3D engine's padded hierarchy, x0 and matrix-free
    arguments (``solvers3d.tiled3d_system``)."""
    rng = np.random.default_rng(seed)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(contrast),
                                        (bsz, nz, ny, nx))),
                     dtype=dtype, device=dev)
    c = fvm3d.fvm_coefficients_3d(d, 0.0, 1.0)
    levels, mf = solvers3d.tiled3d_system(c, d, min_size=4)
    pz, py, px = levels[0].diag.shape[-3:]
    x = torch.zeros((bsz, pz, py, px), dtype=dtype, device=dev)
    x[:, :nz, :ny, :nx] = torch.arange(nx, dtype=dtype, device=dev).div(nx)
    return d, c, levels, x, mf


# (16, 10, 12): even, one band; (13, 9, 22): odd dims, padded; (40, 36, 52):
# several coarse levels
SHAPES_3D = [(16, 10, 12), (13, 9, 22), (40, 36, 52)]
# K7's z-segments start at even slices (a 2x2x2 restriction never straddles
# two CTAs): 37 slices padded to 40 run in five segments of 8 (nu <= 2) or
# four of 12 (nu = 3), the last real slice odd and inside the last one
CROSSING_3D = (37, 20, 40)


# 64^3: two levels (64^3, 32^3) above the resident bottom in float32, three
# in float64
LEVELS_3D = (64, 64, 64)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES_3D + [CROSSING_3D, LEVELS_3D])
def test_v_cycle3d_kernels_match_plain(cuda, dtype, nu, shape):
    """K6, the whole cycle and the banded one, bit for bit, in the launches
    the resident rule gives: two tile passes a level above the bottom and
    one launch for the rest (and T1, T2 for the banded cycle)."""
    _, _, levels, x, _ = _problem3d(cuda, dtype, 2, *shape)
    r = levels[0].b - fvm3d.apply_operator_3d(levels[0], x)
    shapes = [tuple(c.diag.shape[-3:]) for c in levels]
    item = r.element_size()
    mg = dict(omega=SCHEDULES[nu], nu=nu, coarse_iters=8, over=1.8)
    lib = _build.load_library()
    before, tiled = v3.v_cycle3d.launches, v3.v_cycle3d_tiled.launches
    n0 = lib.deff_launch_count()
    z = v3.v_cycle3d(levels, r, **mg)
    n1 = lib.deff_launch_count()
    zt = v3.v_cycle3d_tiled(levels, r, **mg)
    n2 = lib.deff_launch_count()
    torch.cuda.synchronize()
    assert v3.v_cycle3d.launches == before + 2        # + the banded tail
    assert v3.v_cycle3d_tiled.launches == tiled + 1
    assert n1 - n0 == v3.cycle3_launches(shapes, item)
    assert n2 - n1 == 2 + v3.cycle3_launches(shapes[1:], item)
    ref = v3.v_cycle3d_reference(levels, r, **mg)
    assert torch.equal(z, ref), float((z - ref).abs().max())
    ref = v3.v_cycle3d_tiled_reference(levels, r, **mg)
    assert torch.equal(zt, ref), float((zt - ref).abs().max())


@pytest.mark.parametrize("itemsize", [4, 8])
def test_cycle3_rule_python_equals_c(cuda, itemsize):
    """K6's resident rule: the C rule (csrc/vcycle3d.cuh) equals its Python
    twin on config 5's hierarchy and its levels[1:], the test shapes'
    hierarchies and a pyramid whose coarsest level is too large for a
    CTA."""
    lib = _build.load_library()
    c5 = [(256 >> l,) * 3 for l in range(7)]
    cases = [c5, c5[1:], [(40, 36, 52), (20, 18, 26), (10, 10, 14),
                          (5, 5, 7)], [(40, 20, 40), (20, 10, 20), (10, 6, 10),
                                       (5, 3, 5)], [(64, 64, 64)]]
    for shapes in cases:
        n = len(shapes)
        nz, ny, nx = ((ctypes.c_int * n)(*(s[i] for s in shapes))
                      for i in range(3))
        assert lib.deff_cycle3_resident_from(n, nz, ny, nx, itemsize) == \
            v3.cycle3_resident_from(shapes, itemsize), shapes


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mf", [False, True], ids=["stored", "matrix-free"])
@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES_3D + [CROSSING_3D])
def test_cg_steps3d_kernel_matches_plain(cuda, dtype, mf, nu, shape):
    """K7: volume 0 runs the window, 1 is frozen, 2 exits at iteration 0 on
    its stop, 3 overshoots (rz inflated) and trips its hi after one step."""
    _, _, levels, x, mf_kw = _problem3d(cuda, dtype, 4, *shape, seed=1)
    mg = dict(omega=SCHEDULES[nu], nu=nu, coarse_iters=8, over=1.8)
    r = levels[0].b - fvm3d.apply_operator_3d(levels[0], x)
    p = v3.v_cycle3d_tiled_reference(levels, r, **mg)
    rz = torch.sum(r * p, dim=(-3, -2, -1))
    sr0 = torch.sum(r.abs(), dim=(-3, -2, -1))
    rz[3] *= 1e3
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=dtype, device=cuda)
    stop = torch.zeros_like(sr0)
    stop[2] = 10 * sr0[2]
    hi = torch.full_like(sr0, float("inf"))
    hi[3] = 2 * sr0[3]
    extra = mf_kw if mf else {}
    state = (x, r, p, rz, active, stop, hi)
    before = cg_steps3d.launches
    got = cg_steps3d(levels, *(t.clone() for t in state), 4, **mg, **extra)
    ref = cg_steps3d_reference(levels, *(t.clone() for t in state), 4, **mg,
                               **extra)
    torch.cuda.synchronize()
    assert cg_steps3d.launches == before + 1
    _check_cg_window(got, ref, state, dtype, exact_frozen=not mf)


@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_march3_rule_python_equals_c(cuda, itemsize, nu):
    """The z-marching tile and segment rule and the shared memory of K7's
    passes and K6's level passes: the C rule (csrc/march3d.cuh) equals its
    Python twin."""
    lib = _build.load_library()
    for shape in SHAPES_3D + [CROSSING_3D, (104, 64, 90), (256, 256, 256),
                              (2, 2, 2), (64, 2, 300)]:
        plan = march3_plan(shape, itemsize, nu)
        assert lib.deff_march3_seg_len(*shape, itemsize, nu) == \
            plan["seg_len"], shape
        assert lib.deff_march3_level_seg_len(*shape, itemsize) == \
            plan["level_seg_len"], shape
        for (name, mf), nbytes in plan["smem"].items():
            i = PASSES.index(name)
            assert lib.deff_march3_smem(i, itemsize, nu, int(mf)) == \
                nbytes, (shape, name, mf)


@pytest.mark.parametrize("mf", [False, True], ids=["stored", "matrix-free"])
def test_solve_mgcg_3d_on_gpu_matches_plain_on_cpu(cuda, mf):
    d, c, _, _, _ = _problem3d(cuda, torch.float64, 2, 13, 9, 22, seed=2)
    spec = fvm3d.make_flux_spec_3d(d, 0.0, 1.0)
    x0 = torch.arange(22, dtype=torch.float64, device=cuda).div(22)
    x0 = x0.expand(2, 13, 9, 22)
    kw = dict(tol=1e-6, max_iter=200, check_every=5, first_window=1,
              criterion="relresidual", nu1=2, nu2=2, min_size=4,
              coarse_iters=8)
    got = solvers3d.solve_mgcg_3d_batched(c, spec, x0,
                                          d_field=d if mf else None, **kw)
    ref = solvers3d.solve_mgcg_3d_batched(
        fvm3d.StencilCoeffs3D(*(a.cpu() for a in c)),
        type(spec)(*(a.cpu() for a in spec)), x0.cpu(),
        d_field=d.cpu() if mf else None, **kw)
    assert got.iters.cpu().tolist() == ref.iters.tolist()
    torch.testing.assert_close(got.deff.cpu(), ref.deff, rtol=1e-9, atol=0)


def test_3d_wrappers_reject_bad_input(cuda):
    _, _, levels, x, _ = _problem3d(cuda, torch.float32, 2, 16, 10, 12)
    r = levels[0].b - fvm3d.apply_operator_3d(levels[0], x)
    with pytest.raises(ValueError):
        v3.v_cycle3d(levels, r.to(torch.float64))
    with pytest.raises(ValueError):
        v3.v_cycle3d(levels, r[:, :, :, :-1])
    with pytest.raises(ValueError):
        v3.v_cycle3d_tiled(levels, r, nu=4)
    with pytest.raises(ValueError):
        v3.v_cycle3d(levels, r, nu=4)
    one = torch.ones(2, device=cuda)
    with pytest.raises(ValueError):
        cg_steps3d(levels, x.clone(), r.clone(), r.clone(), one, one, 0 * one,
                   one, 2, nu=4)


# ------------------------------------------- the row-sharded engine (K8/K9)

def _sharded_problem(dev, dtype, bsz, ny, nx, sp, seed=0):
    """One mesh row of ``sp`` shards on the card: the sharded hierarchy,
    its coefficient strips and tail, and the shards of a linear x."""
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, halo, mesh

    d, c, _, _ = _problem(dev, dtype, bsz, ny, nx, seed=seed)
    m = mesh.make_mesh(sp, devices=[dev] * sp)
    sh = [mesh.shard_rows(m, a)[0] for a in c]
    row = [fvm.StencilCoeffs(*(f[s] for f in sh)) for s in range(sp)]
    hier = halo._build_sharded_hierarchy_2d(row, ny // sp, min_size=4)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 4)
    x = torch.arange(nx, dtype=dtype, device=dev).div(nx).expand(bsz, ny, nx)
    r = c.b - fvm.apply_operator(c, x)
    return m, c, hier, cw, tail, x.contiguous(), r


SHARD_MG = dict(omega=0.8, coarse_iters=8, over=1.8)


@pytest.mark.parametrize("nu", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_shard_cycle_kernels_match_plain(cuda, sp, dtype, nu, monkeypatch):
    """K8 bit for bit: the one-shard form with the caller's strips, then
    the fused cycle of a row of ``sp`` shards on the card -- one launch a
    leg for the whole row, neighbours read in place (no strip exchanged),
    T1 restricting into the gathered tail's plane -- against its plain
    version."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle_sharded
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, mesh

    m, _, hier, cw, tail, _, r = _sharded_problem(cuda, dtype, 2, 64, 40, sp)
    rs = mesh.shard_rows(m, r)[0]
    rn, rss = mesh.halo_strips(rs, vcycle_sharded.HALO)
    sched = dict(SHARD_MG, omega=SCHEDULES[nu])
    t1 = vcycle_sharded.shard_t1.launches
    for s in range(sp):
        got = vcycle_sharded.shard_t1(cw[0][s], rs[s], rn[s], rss[s],
                                      omega=sched["omega"], nu=nu)
        ref = vcycle_sharded.shard_t1_reference(cw[0][s], rs[s], rn[s],
                                                rss[s], omega=sched["omega"],
                                                nu=nu)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert vcycle_sharded.shard_t1.launches == t1 + sp

    def no_strips(*a, **k):
        raise AssertionError("a strip was exchanged on one device")

    monkeypatch.setattr(vcycle_sharded, "halo_strips", no_strips)
    lib = _build.load_library()
    kw = dict(nu=nu, tail=tail, **sched)
    rows = {}
    counts = (vcycle_sharded.shard_row_t1.launches,
              vcycle_sharded.shard_row_t2.launches, lib.deff_launch_count())
    z = fused2d.v_cycle_sharded_fused(hier, cw, rs, rows=rows, **kw)
    torch.cuda.synchronize()
    tail_levels = tail[1][0]
    assert tail[0] == 1 and list(rows) == [0] and rows[0].gathered is not None
    assert (vcycle_sharded.shard_row_t1.launches,
            vcycle_sharded.shard_row_t2.launches) == (counts[0] + 1,
                                                      counts[1] + 1)
    assert lib.deff_launch_count() - counts[2] == 2 + cycle_launches(
        [tuple(c.diag.shape[-2:]) for c in tail_levels], r.element_size())
    zp = fused2d.v_cycle_sharded_fused(hier, cw, rs, plain=True, **kw)
    for g, e in zip(z, zp):
        assert torch.equal(g, e), float((g - e).abs().max())


def _no_strips_or_gathers(mp):
    """Make every strip exchange and every gather of coarse planes raise."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels import (
        cgstep_sharded, vcycle_sharded)
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, halo, mesh

    def refuse(*a, **k):
        raise AssertionError("a strip was exchanged or a coarse plane "
                             "gathered on one device")

    for mod, name in ((mesh, "halo_strips"), (vcycle_sharded, "halo_strips"),
                      (cgstep_sharded, "halo_strips"),
                      (fused2d, "halo_strips"), (fused2d, "gathered_cycle"),
                      (halo, "all_gather"), (mesh, "all_gather")):
        mp.setattr(mod, name, refuse)


@pytest.mark.parametrize("nu", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sp,ny", [(1, 64), (2, 64), (4, 64), (4, 72)])
def test_shard_cg_steps_kernel_matches_plain(cuda, sp, ny, dtype, nu,
                                             monkeypatch):
    """K9 in the solver's form (``fused2d.k9_coarse``: the restrictions
    written into the gathered tail's plane, the correction read from K2's
    output in place) against its plain version: float32 bit for bit,
    float64 within TOL (the double partials summed in another order).  At
    SP=4 with 72 rows a shard holds 18, so its last tile row is partial.
    The kernel's window exchanges no strip and gathers or splits no coarse
    plane.  Image 0 runs the window, 1 is frozen, 2 exits at iteration 0
    on its stop, 3 overshoots (rz inflated) and trips its hi after one
    step."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels import cgstep_sharded
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, mesh

    m, c, hier, cw, tail, x, r = _sharded_problem(cuda, dtype, 4, ny, 40, sp,
                                                  seed=1)
    sched = dict(SHARD_MG, omega=SCHEDULES[nu])
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    sr0 = torch.sum(r.abs(), dim=(-2, -1))
    rz[3] *= 1e3
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=dtype, device=cuda)
    stop = torch.zeros_like(sr0)
    stop[2] = 10 * sr0[2]
    hi = torch.full_like(sr0, float("inf"))
    hi[3] = 2 * sr0[3]

    def run(fn, plain):
        xs, rs, ps = (mesh.shard_rows(m, t)[0] for t in (x, r, p))
        kw = fused2d.k9_coarse(hier, cw, xs, nu=nu, tail=tail, plain=plain,
                               **sched)
        assert "coarse_plane" in kw
        out = fn(cw[0], xs, rs, ps, rz.clone(), active, stop, hi, 4,
                 omega=sched["omega"], nu=nu, over=sched["over"], **kw)
        return [torch.cat(out[i], dim=-2) for i in range(3)] + list(out[3:])

    before = cgstep_sharded.cg_steps_sharded.launches
    exchanges = cgstep_sharded.cg_steps_sharded.exchanges
    with monkeypatch.context() as mp:
        _no_strips_or_gathers(mp)
        got = run(cgstep_sharded.cg_steps_sharded, False)
        torch.cuda.synchronize()
    ref = run(cgstep_sharded.cg_steps_sharded_reference, True)
    torch.cuda.synchronize()
    assert cgstep_sharded.cg_steps_sharded.launches == before + 1
    assert cgstep_sharded.cg_steps_sharded.exchanges == exchanges
    _check_cg_window(got, ref, (x, r, p, rz), dtype, exact_frozen=True)


@pytest.mark.parametrize("layout", ["pairs", "spread"])
def test_shard_cg_steps_across_devices(cuda, layout):
    """K9's host loop with the shards of a row on several cards (``pairs``:
    two shards a card, the neighbours on one card read in place and the
    pair across cards through strips; ``spread``: one shard a card) against
    its plain version, float32 bit for bit: one launch a pass a card, the
    partials copied between the cards before each finalize."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels import cgstep_sharded
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, mesh

    need = 2 if layout == "pairs" else 4
    if torch.cuda.device_count() < need:
        pytest.skip(f"needs {need} CUDA devices")
    devs = [torch.device("cuda", i) for i in (
        (0, 0, 1, 1) if layout == "pairs" else (0, 1, 2, 3))]
    dtype = torch.float32
    _, c, _, _ = _problem(cuda, dtype, 4, 64, 40, seed=1)
    m = mesh.make_mesh(4, devices=devs)
    sh = [mesh.shard_rows(m, a)[0] for a in c]
    row = [fvm.StencilCoeffs(*(f[s] for f in sh)) for s in range(4)]
    from effectivediffusivityfvm_tpu_torch.parallel import halo

    hier = halo._build_sharded_hierarchy_2d(row, 16, min_size=4)
    cw = fused2d._coef_windows(hier.sharded)
    tail = fused2d.build_fused_tail(hier.sharded, 4)
    x = torch.arange(40, dtype=dtype, device=cuda).div(40).expand(
        4, 64, 40).contiguous()
    r = c.b - fvm.apply_operator(c, x)
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    sr0 = torch.sum(r.abs(), dim=(-2, -1))
    rz[3] *= 1e3
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=dtype, device=cuda)
    stop = torch.zeros_like(sr0)
    stop[2] = 10 * sr0[2]
    hi = torch.full_like(sr0, float("inf"))
    hi[3] = 2 * sr0[3]

    def run(fn, plain):
        xs, rs, ps = (mesh.shard_rows(m, t)[0] for t in (x, r, p))
        kw = fused2d.k9_coarse(hier, cw, xs, nu=2, tail=tail, plain=plain,
                               **SHARD_MG)
        out = fn(cw[0], xs, rs, ps, rz.clone(), active, stop, hi, 4,
                 omega=SHARD_MG["omega"], nu=2, over=SHARD_MG["over"], **kw)
        return ([torch.cat([t.to(cuda) for t in out[i]], dim=-2)
                 for i in range(3)] + list(out[3:]))

    exchanges = cgstep_sharded.cg_steps_sharded.exchanges
    got = run(cgstep_sharded.cg_steps_sharded, False)
    assert cgstep_sharded.cg_steps_sharded.exchanges > exchanges
    ref = run(cgstep_sharded.cg_steps_sharded_reference, True)
    for d in devs:
        torch.cuda.synchronize(d)
    _check_cg_window(got, ref, (x, r, p, rz), dtype, exact_frozen=True)


def test_sharded_solve_on_gpu_matches_plain_on_cpu(cuda):
    from effectivediffusivityfvm_tpu_torch.parallel import halo, mesh

    d, c, _, _ = _problem(cuda, torch.float64, 2, 64, 40, seed=2)
    spec = make_flux_spec(d, 0.0, 1.0)
    x0 = torch.arange(40, dtype=torch.float64, device=cuda).div(40)
    x0 = x0.expand(2, 64, 40)
    kw = dict(tol=1e-6, max_iter=200, check_every=10,
              criterion="relresidual", nu1=2, nu2=2, min_size=4,
              coarse_iters=8)
    got = halo.sharded_solve_mgcg(c, spec, x0,
                                  mesh.make_mesh(4, devices=[cuda] * 4), **kw)
    ref = halo.sharded_solve_mgcg(
        fvm.StencilCoeffs(*(a.cpu() for a in c)),
        type(spec)(*(a.cpu() for a in spec)), x0.cpu(),
        mesh.make_mesh(4, devices=["cpu"] * 4), **kw)
    assert got.iters.cpu().tolist() == ref.iters.tolist()
    torch.testing.assert_close(got.deff.cpu(), ref.deff, rtol=1e-9, atol=0)


def test_sharded_solve_across_devices_matches_one_card(cuda):
    """The fused sharded MGCG solve with its four shards on four cards (K8's
    and K9's host loops, strips between the cards) against the same solve
    on four shards of one card (K9's graph route, neighbours read in
    place): the same iterations and Deff (float64; the sums run in the
    same order on both)."""
    from effectivediffusivityfvm_tpu_torch.parallel import halo, mesh

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    d, c, _, _ = _problem(cuda, torch.float64, 2, 64, 40, seed=2)
    spec = make_flux_spec(d, 0.0, 1.0)
    x0 = torch.arange(40, dtype=torch.float64, device=cuda).div(40)
    x0 = x0.expand(2, 64, 40)
    kw = dict(tol=1e-6, max_iter=200, check_every=10,
              criterion="relresidual", nu1=2, nu2=2, min_size=4,
              coarse_iters=8)
    one = halo.sharded_solve_mgcg(c, spec, x0,
                                  mesh.make_mesh(4, devices=[cuda] * 4), **kw)
    four = halo.sharded_solve_mgcg(
        c, spec, x0, mesh.make_mesh(4, devices=[torch.device("cuda", i)
                                                for i in range(4)]), **kw)
    assert four.iters.cpu().tolist() == one.iters.cpu().tolist()
    torch.testing.assert_close(four.deff.cpu(), one.deff.cpu(), rtol=1e-12,
                               atol=0)


def test_shard_cg_steps_window_ends_with_the_last_live_image(cuda):
    """K9 on two images that both reach their stop at iteration 3 of a k=10
    window: the graph route replays at most WINDOW_LAG iterations after the
    third (it reads a flag the live finalize marks, one iteration behind),
    the K2 tail does work in three iterations for each image (the device
    count of image cycles; a replay after the last live one is gated), and
    x/r/p equal a k=3 window's."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels import cgstep_sharded
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, mesh

    m, c, hier, cw, tail, x, r = _sharded_problem(cuda, torch.float64, 2, 32,
                                                  16, 2, seed=12)
    assert tail[0] == 1                         # the coarse levels are K2's
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    lib = _build.load_library()
    ones = torch.ones(2, dtype=torch.float64, device=cuda)

    def run(k, stop):
        xs, rs, ps = (mesh.shard_rows(m, t.clone())[0] for t in (x, r, p))
        c0 = lib.deff_image_cycle_count()
        out = cgstep_sharded.cg_steps_sharded(
            cw[0], xs, rs, ps, rz, ones, stop, float("inf") * ones, k,
            coarse=lambda rc, live: fused2d.v_cycle_sharded_fused(
                hier, cw, rc, level=1, tail=tail, live=live, nu=2,
                **SHARD_MG),
            omega=0.8, nu=2, over=1.8)
        torch.cuda.synchronize()
        return ([torch.cat(out[i], dim=-2) for i in range(3)],
                out[4].tolist(), lib.deff_image_cycle_count() - c0)

    srs = [r.abs().sum(dim=(-2, -1))]
    for k in (1, 2, 3):
        planes, kd, cyc = run(k, 0 * ones)
        assert kd == [k, k] and cyc == 2 * k
        srs.append(planes[1].abs().sum(dim=(-2, -1)))
    first = torch.stack(srs[:3]).min(dim=0).values
    stop = (srs[3] + first) / 2
    assert bool(torch.all((srs[3] < stop) & (stop < first)))
    r0 = cgstep_sharded.cg_steps_sharded.replays
    got, kd, cycles = run(10, stop)
    assert kd == [3, 3]
    # the window leaves at most WINDOW_LAG replays after the last live one
    replays = cgstep_sharded.cg_steps_sharded.replays - r0
    assert 3 <= replays <= 3 + cgstep_sharded.WINDOW_LAG
    assert cycles == 2 * 3                      # live iterations, no more
    for g, w in zip(got, planes):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sp", [1, 4])
def test_shard_cg_steps_graph_route_equals_host_loop(cuda, sp, dtype):
    """K9's graph route (shards on one device) against its host loop, bit for
    bit in x, r, p, rz and k_done, over two windows of one workspace (the
    second replays the graphs captured in the first): image 0 runs both
    windows, 1 is frozen, 2 exits at iteration 0, 3 trips its hi."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels import cgstep_sharded
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, mesh

    m, c, hier, cw, tail, x, r = _sharded_problem(cuda, dtype, 4, 64, 40, sp,
                                                  seed=1)
    p = r * c.diag_inv
    rz = torch.sum(r * p, dim=(-2, -1))
    sr0 = torch.sum(r.abs(), dim=(-2, -1))
    rz[3] *= 1e3
    active = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=dtype, device=cuda)
    stop = torch.zeros_like(sr0)
    stop[2] = 10 * sr0[2]
    hi = torch.full_like(sr0, float("inf"))
    hi[3] = 2 * sr0[3]

    def coarse(rc, live):
        return fused2d.v_cycle_sharded_fused(hier, cw, rc, nu=2, level=1,
                                             tail=tail, live=live, **SHARD_MG)

    def run(graph):
        xs, rs, ps = (mesh.shard_rows(m, t)[0] for t in (x, r, p))
        w = cgstep_sharded.ShardWorkspace(cw[0], xs, graph=graph)
        rzw, outs = rz.clone(), []
        for k in (3, 5):
            out = cgstep_sharded.cg_steps_sharded(
                cw[0], xs, rs, ps, rzw, active, stop, hi, k, coarse=coarse,
                omega=0.8, nu=2, over=1.8, workspace=w)
            rzw = out[3]
            outs.append([torch.cat(out[i], dim=-2).clone() for i in range(3)]
                        + [out[3].clone(), out[4].clone()])
        return w, outs

    r0 = cgstep_sharded.cg_steps_sharded.replays
    wg, graphed = run(True)
    assert wg.graphed and cgstep_sharded.cg_steps_sharded.replays == r0 + 8
    wl, looped = run(False)
    assert not wl.graphed and cgstep_sharded.cg_steps_sharded.replays == r0 + 8
    torch.cuda.synchronize()
    assert graphed[0][4].tolist() == [3, 0, 0, 1]
    assert graphed[1][4].tolist() == [5, 0, 0, 0]
    for g_win, l_win in zip(graphed, looped):
        for g, h in zip(g_win, l_win):
            assert torch.equal(g, h)
    for g, s in zip(graphed[1][:3], (x, r, p)):
        assert torch.equal(g[1], s[1])          # frozen: bit-unchanged


# ------------------------------------------------------------ dmg on K2/K4


def _gas_blobs(dev, n, seed=0):
    """Gas discs (D = 1e6) in fluid (D = 1), float64, one disc of radius
    n/5 among them (a long segment for the coarse apply)."""
    rng = np.random.default_rng(seed)
    img = np.full((n, n), 150, np.uint8)
    ii, jj = np.ogrid[:n, :n]
    for k in range(n // 16):
        ci, cj = rng.integers(8, n - 8, 2)
        r = n // 5 if k == 0 else int(rng.integers(3, 10))
        img[(ii - ci) ** 2 + (jj - cj) ** 2 < r * r] = 0
    classes = phases.three_phase_classes(img)
    d = torch.tensor(phases.d_field_from_classes(classes, 1.0, 0.0, 1e6,
                                                 dtype=np.float64),
                     device=dev)
    x0 = (torch.arange(n, dtype=torch.float64, device=dev) / n).expand(
        n, n).clone()
    return (fvm.fvm_coefficients(d, 0.0, 1.0), make_flux_spec(d, 0.0, 1.0),
            x0, classes == phases.GAS)


@pytest.mark.parametrize("use_pallas,n", [(True, 256), ("tiled", 256),
                                          (None, 512)])
def test_solve_dmg_kernels_match_plain(cuda, use_pallas, n):
    """dmg's cycle on K2 (forced, and auto at 512^2) and on K4 (forced):
    the kernels are bit-equal to their plain versions, so the solves are
    too."""
    c, s, x0, gas = _gas_blobs(cuda, n)
    kw = dict(member=gas, tol=1e-10, max_iter=400, use_pallas=use_pallas)
    before = (v_cycle.launches, vt.v_cycle_tiled.launches)
    got = dmg.solve_dmg(c, s, x0, **kw)
    torch.cuda.synchronize()
    k2, k4 = (v_cycle.launches - before[0],
              vt.v_cycle_tiled.launches - before[1])
    assert (k4 > 0 and k2 == 0) if use_pallas == "tiled" else (
        k2 > 0 and k4 == 0)
    assert k2 + k4 >= int(got.iters)             # a cycle an iteration
    ref = dmg.solve_dmg(c, s, x0, plain=True, **kw)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-10)
    assert float(got.conv) == float(ref.conv) and float(got.conv) < 1e-6


def test_coarse_apply_is_the_same_every_run(cuda):
    c, _, _, gas = _gas_blobs(cuda, 512)
    space = deflation.build_component_deflation(c, gas)
    gen = torch.Generator(device="cpu").manual_seed(3)
    r = torch.randn((512, 512), generator=gen, dtype=torch.float64).to(cuda)
    w = torch.rand((512, 512), generator=gen, dtype=torch.float64).to(cuda)
    seg = deflation.Segments(space)
    runs = [deflation._coarse_apply(space, r, w, seg) for _ in range(3)]
    assert all(torch.equal(runs[0], other) for other in runs[1:])
    cpu = deflation._coarse_apply(
        deflation.DeflationSpace(*(t.cpu() for t in space[:3]), m=space.m),
        r.cpu(), w.cpu())
    np.testing.assert_allclose(runs[0].cpu().numpy(), cpu.numpy(),
                               rtol=1e-11, atol=1e-13 * float(cpu.abs().max()))


@pytest.mark.parametrize("ndim,batched", [(2, False), (2, True), (3, True)])
def test_rbsor_graph_route_matches_cpu(cuda, ndim, batched):
    """On the card the red-black sweep replays as a CUDA graph; the sweep
    has no reduction, so the card and the CPU give the same numbers."""
    rng = np.random.default_rng(4)
    shape = (2,) * batched + ((12, 16, 20) if ndim == 3 else (48, 40))
    d = torch.tensor(np.exp(rng.uniform(0, np.log(1e3), shape)))
    nx = shape[-1]
    if ndim == 3:
        c, s = fvm3d.fvm_coefficients_3d(d, 0.0, 1.0), fvm3d.make_flux_spec_3d(
            d, 0.0, 1.0)
        solve = (solvers3d.solve_rbsor_3d_batched if batched
                 else solvers3d.solve_rbsor_3d)
    else:
        c, s = fvm.fvm_coefficients(d, 0.0, 1.0), make_flux_spec(d, 0.0, 1.0)
        solve = rbsor.solve_rbsor_batched if batched else rbsor.solve_rbsor
    x0 = (torch.arange(nx, dtype=torch.float64) / nx).expand(shape)
    kw = dict(tol=1e-9, max_iter=20_000, check_every=100, criterion="deff")
    ref = solve(c, s, x0, **kw)
    got = solve(type(c)(*(a.to(cuda) for a in c)),
                type(s)(*(a.to(cuda) for a in s)), x0.to(cuda), **kw)
    assert got.iters.tolist() == ref.iters.tolist()
    np.testing.assert_allclose(got.deff.cpu().numpy(), ref.deff.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(got.x.cpu().numpy(), ref.x.numpy(),
                               rtol=1e-12, atol=1e-14)


# ------------------------------------------ the rest of the solver matrix

def _gas_volume(n, seed=3):
    """A small 3-phase volume: fluid with gas balls, two through the x
    faces, and a few solid ones."""
    rng = np.random.default_rng(seed)
    v = np.full((n, n, n), 150, np.uint8)
    kk, ii, jj = np.ogrid[:n, :n, :n]
    for k in range(8):
        c = rng.integers(0, n, 3)
        c[2] = (0, n - 1)[k] if k < 2 else c[2]
        v[(kk - c[0]) ** 2 + (ii - c[1]) ** 2 + (jj - c[2]) ** 2 < 16] = 0
    for _ in range(3):
        c = rng.integers(0, n, 3)
        v[(kk - c[0]) ** 2 + (ii - c[1]) ** 2 + (jj - c[2]) ** 2 < 9] = 255
    return v


@pytest.mark.parametrize("use_pallas", [True, "tiled3d"])
def test_solve_dmg_3d_kernels_match_plain(cuda, use_pallas):
    """dmg3d's cycle on K6 (whole and banded) against its plain version:
    the same iterations, Deff to 1e-9."""
    from effectivediffusivityfvm_tpu_torch.models import volume
    from effectivediffusivityfvm_tpu_torch.solvers import dmg3d

    vol = _gas_volume(32)
    classes = phases.three_phase_classes(vol)
    mask = (vol > 200) | volume.flood_fill_3d(vol > 200).isolated
    gas = (classes == phases.GAS) & ~mask
    d = torch.tensor(phases.d_field_from_classes(classes, 1.0, 0.0, 1e3,
                                                 dtype=np.float64),
                     device=cuda)
    c = fvm3d.fvm_coefficients_3d(d, 0.0, 1.0, mask=torch.as_tensor(
        mask, device=cuda), symmetric=True)
    s = fvm3d.make_flux_spec_3d(d, 0.0, 1.0)
    x0 = (torch.arange(32, dtype=torch.float64, device=cuda) / 32).expand(
        32, 32, 32)
    kw = dict(member=gas, tol=1e-10, max_iter=400, check_every=10,
              use_pallas=use_pallas)
    key = v3.v_cycle3d if use_pallas is True else v3.v_cycle3d_tiled
    key.launches = 0
    got = dmg3d.solve_dmg_3d(c, s, x0, **kw)
    assert key.launches > 0
    ref = dmg3d.solve_dmg_3d(c, s, x0, plain=True, **kw)
    assert int(got.iters) == int(ref.iters)
    assert float(got.conv) <= 1e-10
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-9)


def test_compacted_batch_matches_unsegmented(cuda):
    """Compaction on K1/K2: every image converged, Deff within the
    unsegmented batch's to 1e-6."""
    from effectivediffusivityfvm_tpu_torch.solvers.compact import \
        solve_batched_compacted

    rng = np.random.default_rng(6)
    d = torch.tensor(np.stack([np.exp(rng.uniform(0, np.log(10.0 ** k),
                                                  (64, 64)))
                               for k in range(1, 7)]), device=cuda)
    c, s = fvm.fvm_coefficients(d, 0.0, 1.0), make_flux_spec(d, 0.0, 1.0)
    x0 = (torch.arange(64, dtype=torch.float64, device=cuda) / 64).expand(
        6, 64, 64)
    kw = dict(tol=1e-9, max_iter=400, check_every=10, criterion="residual",
              min_size=8, coarse_iters=8, nu1=2, nu2=2)
    ref = multigrid.solve_mgcg_batched(c, s, x0, **kw)
    cg_steps.launches = 0
    got = solve_batched_compacted(multigrid.solve_mgcg_batched, c, s, x0,
                                  segment=20, **kw)
    assert cg_steps.launches > 0
    assert bool(torch.all(got.conv <= 1e-9))
    np.testing.assert_allclose(got.deff.cpu().numpy(), ref.deff.cpu().numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("ny, use_pallas, nu", [(36, None, 2), (32, False, 2),
                                                (32, None, 5)])
def test_sharded_pcg_routes_match_plain(cuda, ny, use_pallas, nu):
    """Routes (a) and (b) under run_pcg on four shards of the card: K2
    (the gathered tail) against its plain version, the same iterations."""
    from effectivediffusivityfvm_tpu_torch.parallel import halo
    from effectivediffusivityfvm_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(8)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(10.0), (ny, 64))),
                     device=cuda)
    c, s = fvm.fvm_coefficients(d, 0.0, 1.0), make_flux_spec(d, 0.0, 1.0)
    x0 = (torch.arange(64, dtype=torch.float64, device=cuda) / 64).expand(
        ny, 64)
    mesh = make_mesh(4, dp=1, sp=4, devices=[cuda] * 4)
    kw = dict(tol=1e-9, max_iter=300, check_every=10,
              criterion="relresidual", nu1=nu, nu2=nu, use_pallas=use_pallas)
    v_cycle.launches = 0
    got = halo.sharded_solve_mgcg(c, s, x0, mesh, **kw)
    assert v_cycle.launches > 0
    ref = halo.sharded_solve_mgcg(c, s, x0, mesh, plain=True, **kw)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-9)


def test_sharded_3d_tail_matches_plain(cuda):
    """The z-slab sharded MGCG with its gathered tail on K6 against K6's
    plain version."""
    from effectivediffusivityfvm_tpu_torch.parallel import halo3d
    from effectivediffusivityfvm_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(9)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(1e2), (32, 24, 24))),
                     device=cuda)
    c, s = fvm3d.fvm_coefficients_3d(d, 0.0, 1.0), fvm3d.make_flux_spec_3d(
        d, 0.0, 1.0)
    x0 = (torch.arange(24, dtype=torch.float64, device=cuda) / 24).expand(
        32, 24, 24)
    mesh = make_mesh(4, dp=1, sp=4, devices=[cuda] * 4)
    kw = dict(tol=1e-9, max_iter=200, check_every=10, nu1=2, nu2=2)
    v3.v_cycle3d.launches = 0
    got = halo3d.sharded_solve_mgcg_3d(c, s, x0, mesh, **kw)
    assert v3.v_cycle3d.launches > 0
    ref = halo3d.sharded_solve_mgcg_3d(c, s, x0, mesh, plain=True, **kw)
    assert int(got.iters) == int(ref.iters)
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-9)


def test_native_flood_fill_on_the_card_machine(cuda):
    """The native library builds on this machine and agrees with the scipy
    route and with the label propagation on the card."""
    from effectivediffusivityfvm_tpu_torch.models import _native, floodfill

    assert _native.native_available()
    rng = np.random.default_rng(10)
    solid = rng.random((6, 96, 80)) < 0.42
    part, iso, flag = floodfill.participating_mask_device(
        torch.as_tensor(solid, device=cuda))
    for k, m in enumerate(solid):
        a = floodfill.flood_fill(m)
        b = floodfill.flood_fill(m, use_native=False)
        assert np.array_equal(a.participating, b.participating)
        assert np.array_equal(a.participating, part[k].cpu().numpy())
        assert np.array_equal(a.isolated, iso[k].cpu().numpy())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_differentiable_deff_on_the_kernels_matches_plain(cuda, dtype):
    """``deff_and_grad`` of a B=2 x 64^2 field on K1/K2 (forward and adjoint
    solves) against the same call on their plain versions: the same
    iterations (within 2 in float32), values and gradients to the kernels'
    tolerance."""
    from effectivediffusivityfvm_tpu_torch.ops.autodiff import (
        deff_and_grad, make_differentiable_deff)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import cg_steps

    rng = np.random.default_rng(12)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(30), (2, 64, 64))),
                     dtype=dtype, device=cuda)
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    runs = {}
    for plain in (False, True):
        f = make_differentiable_deff(tol=tol, max_iter=500,
                                     solver_kw={"plain": plain})
        dd = d.clone().requires_grad_()
        before = (cg_steps.launches, v_cycle.launches)
        val = f(dd)
        (grad,) = torch.autograd.grad(val.sum(), dd)
        torch.cuda.synchronize()
        launched = (cg_steps.launches - before[0],
                    v_cycle.launches - before[1])
        runs[plain] = (val.detach(), grad, dict(f.iterations), launched)
    (v, g, its, launched), (vp, gp, itsp, launched_p) = runs[False], runs[True]
    assert launched[0] > 0 and launched[1] > 0 and launched_p == (0, 0)
    slack = 0 if dtype == torch.float64 else 2
    for k in ("forward", "adjoint"):
        assert int((its[k] - itsp[k]).abs().max()) <= slack, (k, its[k],
                                                              itsp[k])
    torch.testing.assert_close(v, vp, rtol=TOL[dtype], atol=0)
    assert _rel_err(g, gp) <= TOL[dtype]
    v1, g1 = deff_and_grad(d[1], tol=tol, max_iter=500)
    torch.testing.assert_close(v1, v[1], rtol=TOL[dtype], atol=0)
    assert _rel_err(g1, g[1]) <= TOL[dtype]
