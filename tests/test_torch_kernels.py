"""The plain versions of the port's kernels (K2 V-cycle, K1 fused CG steps)
against the JAX Pallas kernels run in interpret mode, on the CPU.

Both sides get the identical hierarchy (handed to the port through
``convert.levels_from_numpy``) and identical state, in float64.  The
V-cycle is a fixed sequence of stencil passes: rtol 1e-11.  The CG steps add
full-plane dot products whose summation order differs between XLA and
torch, amplified over k=3 iterations: rtol 1e-10.  On CPU tensors the
wrappers ``v_cycle``/``cg_steps`` take the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.kernels.cgstep_vmem import \
    cg_steps_pallas
from effectivediffusivityfvm_tpu.ops.kernels.vcycle_vmem import \
    v_cycle_pallas
from effectivediffusivityfvm_tpu_torch.convert import levels_from_numpy
from effectivediffusivityfvm_tpu_torch.ops import fvm as tfvm
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
    cg_steps, cg_steps_reference)
from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import (
    cycle_launches, cycle_resident_from, smoothing_schedule, v_cycle,
    v_cycle_reference)
from effectivediffusivityfvm_tpu_torch.solvers.multigrid import \
    build_hierarchy

MG = dict(omega=(1.281, 0.5584), nu=2, coarse_iters=8, over=1.8)
F64 = torch.float64
# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)


def _levels(seed, bsz, ny, nx, contrast=1e4):
    """The hierarchy for JAX (its parity with the port's
    ``build_hierarchy`` is test_torch_ops' job; building it with the port
    skips JAX's per-op compiles) and a random residual, zero on padded
    cells."""
    rng = np.random.default_rng(seed)
    d = np.exp(rng.uniform(0, np.log(contrast), (bsz, ny, nx)))
    c = tfvm.fvm_coefficients(torch.tensor(d), 0.0, 1.0)
    lv = [jfvm.StencilCoeffs(*(jnp.asarray(a.numpy()) for a in lvl))
          for lvl in build_hierarchy(c, min_size=4, pad_levels=True)]
    py, px = lv[0].diag.shape[-2:]
    r = np.zeros((bsz, py, px))
    r[:, :ny, :nx] = rng.standard_normal((bsz, ny, nx))
    return lv, r


@pytest.fixture(scope="module", params=[(16, 24), (15, 23)],
                ids=["16x24", "15x23"])
def cycle_case(request):
    ny, nx = request.param
    lv, r = _levels(5, 2, ny, nx)
    z = np.asarray(v_cycle_pallas(lv, jnp.asarray(r), interpret=True, **MG))
    return lv, r, z


def test_v_cycle_reference_matches_pallas(cycle_case):
    lv, r, z_ref = cycle_case
    z = v_cycle_reference(levels_from_numpy(lv, "cpu", F64),
                          torch.tensor(r), **MG)
    np.testing.assert_allclose(z.numpy(), z_ref, rtol=1e-11,
                               atol=1e-11 * np.abs(z_ref).max())


def test_v_cycle_wrapper_takes_plain_version_on_cpu(cycle_case):
    lv, r, _ = cycle_case
    levels = levels_from_numpy(lv, "cpu", F64)
    before = v_cycle.launches
    got = v_cycle(levels, torch.tensor(r), **MG)
    ref = v_cycle_reference(levels, torch.tensor(r), **MG)
    assert torch.equal(got, ref)
    assert v_cycle.launches == before       # counts kernel launches only


def test_v_cycle_rejects_odd_levels():
    lv, r = _levels(5, 1, 16, 24)
    levels = levels_from_numpy(lv, "cpu", F64)
    odd = [c._replace(diag=c.diag[..., :-1, :]) for c in levels]
    with pytest.raises(ValueError, match="even"):
        v_cycle_reference(odd, torch.tensor(r), **MG)


def test_smoothing_schedule():
    assert smoothing_schedule(0.8, 2) == (0.8, 0.8)
    assert smoothing_schedule((1.281, 0.5584), 2) == (1.281, 0.5584)
    with pytest.raises(ValueError):
        smoothing_schedule((1.0, 0.5), 3)


# K2's resident rule on the hierarchies the card runs (shapes only; the
# padded-even coarsening of build_hierarchy): the MGCG slice (512^2,
# min_size 8; K1 runs the cycle from level 1), config 3's K2 tail (levels
# 1.. of the banded 2048^2 hierarchy, min_size 32) and the gathered tails of
# the sharded engine (config 3 at SP=4 gathers level 1, 1024^2; 4096^2
# gathers level 2, also 1024^2).
SLICE = [(512, 512), (256, 256), (128, 128), (64, 64), (32, 32), (16, 16),
         (8, 8)]
TAIL_1024 = [(1024, 1024), (512, 512), (256, 256), (128, 128), (64, 64),
             (32, 32)]


@pytest.mark.parametrize("shapes,l0,item,resident,launches", [
    (SLICE, 1, 4, 3, 5),          # 256, 128 in passes; 64^2 down resident
    (SLICE, 1, 8, 4, 7),          # float64: 64^2 no longer fits one CTA
    (SLICE, 0, 4, 3, 7),          # the whole cycle (fresh, refresh)
    (TAIL_1024, 0, 4, 4, 9),      # config 3's tail and the sharded tail
    (TAIL_1024, 0, 8, 5, 11),     # the 4096^2 float64 sharded tail
    ([(160, 144)], 0, 4, 1, 1),   # one level too large: global sweeps
    ([(8, 8)], 0, 8, 0, 1),       # one level, resident
], ids=["slice-f32", "slice-f64", "slice-whole", "tail-f32", "tail-f64",
        "one-level-global", "one-level-resident"])
def test_cycle_resident_rule(shapes, l0, item, resident, launches):
    assert cycle_resident_from(shapes, item) == resident
    assert cycle_launches(shapes, item, l0) == launches


def test_cycle_resident_rule_on_built_hierarchy():
    """The slice's shapes above are build_hierarchy's at 512^2."""
    d = torch.ones((1, 512, 512), dtype=torch.float32)
    levels = build_hierarchy(tfvm.fvm_coefficients(d, 0.0, 1.0), min_size=8,
                             pad_levels=True)
    assert [tuple(c.diag.shape[-2:]) for c in levels] == SLICE


@pytest.fixture(scope="module")
def cg_case():
    """B=4: image 0 iterates the full window, image 1 is frozen, image 2's
    stop exits it at iteration 0, image 3's rz is inflated 1e3x so its first
    step overshoots and the tripwire (hi = 2 sum|r_in|) stops it after one
    iteration."""
    bsz, k = 4, 3
    lv, _ = _levels(9, bsz, 16, 24)
    c0 = lv[0]
    ny, nx = 16, 24
    x = np.broadcast_to(np.arange(nx) / nx, (bsz, ny, nx)).copy()
    r = np.asarray(c0.b - jfvm.apply_operator(c0, jnp.asarray(x)))
    p = v_cycle_reference(levels_from_numpy(lv, "cpu", F64),
                          torch.tensor(r), **MG).numpy()
    rz = np.sum(r * p, axis=(-2, -1))
    sr0 = np.sum(np.abs(r), axis=(-2, -1))
    active = np.array([1.0, 0.0, 1.0, 1.0])
    stop = np.array([0.0, 0.0, 10.0 * sr0[2], 0.0])
    hi = np.array([1e300, 1e300, 1e300, 2.0 * sr0[3]])
    rz[3] *= 1e3
    out = cg_steps_pallas(
        lv, jnp.asarray(x), jnp.asarray(r), jnp.asarray(p),
        jnp.asarray(rz)[:, None], jnp.asarray(active)[:, None],
        jnp.asarray(stop)[:, None], jnp.asarray(hi)[:, None],
        jnp.asarray(k, jnp.int32), interpret=True, refresh=True, **MG)
    ref = [np.asarray(o) for o in out]
    ref[3:] = [a[:, 0] for a in ref[3:]]
    return lv, (x, r, p, rz, active, stop, hi, k), ref


def _run_cg(fn, cg_case):
    lv, (x, r, p, rz, active, stop, hi, k), _ = cg_case
    t = [torch.tensor(a) for a in (x, r, p, rz, active, stop, hi)]
    return fn(levels_from_numpy(lv, "cpu", F64), *t, k, **MG)


def test_cg_steps_reference_matches_pallas(cg_case):
    _, (x, r, p, rz, *_), ref = cg_case
    got = [o.numpy() for o in _run_cg(cg_steps_reference, cg_case)]
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[4], [3, 0, 0, 1])
    for g, e in zip(got[:4] + got[5:], ref[:4] + ref[5:]):
        np.testing.assert_allclose(g, e, rtol=1e-10,
                                   atol=1e-10 * np.abs(e).max())
    # the frozen image passes through untouched
    for g, a in zip(got[:4], (x, r, p, rz)):
        np.testing.assert_array_equal(g[1], a[1])
    assert got[5][1] == 0.0


def test_cg_steps_wrapper_takes_plain_version_on_cpu(cg_case):
    before = cg_steps.launches
    got = _run_cg(cg_steps, cg_case)
    ref = _run_cg(cg_steps_reference, cg_case)
    for g, e in zip(got, ref):
        assert torch.equal(g, e)
    assert cg_steps.launches == before


def test_cg_steps_updates_state_in_place(cg_case):
    lv, (x, r, p, rz, active, stop, hi, k), _ = cg_case
    t = [torch.tensor(a) for a in (x, r, p, rz, active, stop, hi)]
    out = cg_steps_reference(levels_from_numpy(lv, "cpu", F64), *t, k, **MG)
    for o, i in zip(out[:3], t[:3]):
        assert o is i
