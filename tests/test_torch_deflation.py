"""The port's deflated solvers against the JAX package on the CPU, in
float64: ``label_components``, ``build_component_deflation``, the
segment-sum ``_coarse_apply``, ``solve_dcg*`` and ``solve_dmg`` on the
plain versions of K2 (``use_pallas=True``) and K4 (``"tiled"``) against the
JAX package's Pallas cycles in interpret mode; then the port alone:
``solve_dmg_batched`` against its single solves, ``solve_dmg_refined``,
``_dmg_engine_auto`` and the refusals.

Tolerances: labels equal; the coarse factors rtol 1e-12 and the coarse
apply 1e-13 (sums in another order); dcg Deff rtol 1e-8; dmg Deff rtol 1e-7
(float32 cycles whose restriction is a matmul on the TPU side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.solvers import deflation as jdefl
from effectivediffusivityfvm_tpu.solvers import dmg as jdmg
from effectivediffusivityfvm_tpu_torch.models import floodfill, phases
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.solvers import (deflation, dispatch,
                                                       dmg)

# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)


def _blob_image(seed, n=48, blobs=8):
    """tests/test_cg.py's 3-phase blobs: gas discs (0) in fluid (150)."""
    rng = np.random.default_rng(seed)
    img = np.full((n, n), 150, np.uint8)
    ii, jj = np.ogrid[:n, :n]
    for _ in range(blobs):
        ci, cj = rng.integers(4, n - 4, 2)
        r = rng.integers(2, 5)
        img[(ii - ci) ** 2 + (jj - cj) ** 2 < r * r] = 0
    return img


def _system(img, contrast=1e6, masked=True):
    """``(coeffs, spec, x0, gas)`` of a 3-phase image, symmetric masked
    assembly, float64; ``masked=False`` assembles the D field alone (solid
    D = 0), whose gas cells ringed by solid keep no external conductance."""
    n = img.shape[-1]
    classes = phases.three_phase_classes(img)
    ff = floodfill.flood_fill(img > 200)
    mask = ((img > 200) | ff.isolated) if masked else np.zeros(img.shape,
                                                                bool)
    gas = (classes == phases.GAS) & ~mask
    d = torch.tensor(phases.d_field_from_classes(classes, 1.0, 0.0, contrast,
                                                 dtype=np.float64))
    c = fvm.fvm_coefficients(d, 0.0, 1.0, mask=torch.tensor(mask),
                             symmetric=True)
    spec = make_flux_spec(d, 0.0, 1.0)
    x0 = (torch.arange(n, dtype=torch.float64) / n).expand(img.shape).clone()
    return c, spec, x0, gas


def _to_jax(tree):
    return type(tree)(*(jnp.asarray(a.numpy()) for a in tree))


def _enclosed_gas(n=24):
    """A gas blob that touches the fluid, one ringed by solid (no external
    conductance: dropped from the space) and one across the bottom and top
    rows (one component only when Y is periodic)."""
    img = np.full((n, n), 150, np.uint8)
    img[4:8, 4:8] = 0
    img[12:19, 12:19] = 255
    img[14:17, 14:17] = 0
    img[:3, 9:12] = 0
    img[-2:, 9:12] = 0
    return img


# ------------------------------------------------------------ the space


@pytest.mark.parametrize("periodic_y", [False, True])
def test_label_components_matches_jax(periodic_y):
    masks = [_enclosed_gas() == 0,
             np.random.default_rng(3).random((20, 17)) < 0.45]
    for member in masks:
        ref = jdefl.label_components(member, periodic_y)
        got = deflation.label_components(member, periodic_y)
        np.testing.assert_array_equal(got, ref)
    merged = deflation.label_components(masks[0], True)
    assert merged.max() + 1 == deflation.label_components(masks[0],
                                                          False).max()


@pytest.mark.parametrize("case", ["enclosed", "blobs"])
def test_build_component_deflation_matches_jax(case):
    img = _enclosed_gas() if case == "enclosed" else _blob_image(1)
    c, _, _, gas = _system(img, masked=case != "enclosed")
    ref = jdefl.build_component_deflation(_to_jax(c), gas,
                                          assemble_on_device=False)
    got = deflation.build_component_deflation(c, gas)
    assert got.m == ref.m
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.e_hat_inv.numpy(),
                               np.asarray(ref.e_hat_inv), rtol=1e-12,
                               atol=1e-12 * float(np.abs(ref.e_hat_inv).max()))
    np.testing.assert_allclose(got.dhalf_inv.numpy(),
                               np.asarray(ref.dhalf_inv), rtol=1e-12)
    if case == "enclosed":      # the island ringed by solid is dropped
        assert got.m == int(deflation.label_components(gas, False).max())
        assert np.all(got.labels.numpy()[14:17, 14:17] == -1)


@pytest.mark.parametrize("weighted", [False, True])
def test_coarse_apply_matches_jax(weighted):
    c, _, _, gas = _system(_blob_image(2))
    space = deflation.build_component_deflation(c, gas)
    jspace = jdefl.DeflationSpace(
        labels=jnp.asarray(space.labels.numpy()),
        e_hat_inv=jnp.asarray(space.e_hat_inv.numpy()),
        dhalf_inv=jnp.asarray(space.dhalf_inv.numpy()), m=space.m)
    rng = np.random.default_rng(5)
    r = rng.uniform(0.5, 1.5, gas.shape)
    w = rng.uniform(0.5, 2.0, gas.shape) if weighted else None
    ref = np.asarray(jdefl._coarse_apply(
        jspace, jnp.asarray(r), None if w is None else jnp.asarray(w)))
    got = deflation._coarse_apply(space, torch.tensor(r),
                                  None if w is None else torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13)
    assert np.all(got.numpy()[space.labels.numpy() < 0] == 0)
    # a kept segment table gives the same numbers
    seg = deflation.Segments(space)
    again = deflation._coarse_apply(space, torch.tensor(r),
                                    None if w is None else torch.tensor(w),
                                    seg)
    assert torch.equal(again, got)


# ------------------------------------------------------------ dcg


def test_solve_dcg_matches_jax():
    c, s, x0, gas = _system(_blob_image(1))
    kw = dict(tol=1e-8, max_iter=5000, check_every=100)
    ref = jdefl.solve_dcg(_to_jax(c), _to_jax(s), jnp.asarray(x0.numpy()),
                          member=gas, **kw)
    got = deflation.solve_dcg(c, s, x0, member=gas, **kw)
    assert int(got.iters) == int(ref.iters)
    assert float(got.conv) <= 1e-8 and float(ref.conv) <= 1e-8
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-8)
    via = dispatch.solve("dcg", c, s, x0, member=gas, omega=0.0, **kw)
    assert torch.equal(via.x, got.x)


def test_solve_dcg_batched_matches_jax():
    imgs = np.stack([_blob_image(1), _blob_image(2, blobs=3)])
    systems = [_system(im) for im in imgs]
    c = fvm.StencilCoeffs(*(torch.stack(f) for f in zip(*(t[0]
                                                           for t in systems))))
    s = type(systems[0][1])(*(torch.stack(f) for f in zip(
        *(t[1] for t in systems))))
    x0 = torch.stack([t[2] for t in systems])
    gas = np.stack([t[3] for t in systems])
    kw = dict(tol=1e-8, max_iter=5000, check_every=100)
    ref = jdefl.solve_dcg_batched(_to_jax(c), _to_jax(s),
                                  jnp.asarray(x0.numpy()), members=gas, **kw)
    got = deflation.solve_dcg_batched(c, s, x0, members=gas, **kw)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(ref.deff),
                               rtol=1e-8)
    assert np.all(got.conv.numpy() <= 1e-8)
    # each image as its own solve (the frozen one kept its state)
    for k in range(2):
        one = deflation.solve_dcg(*(type(t)(*(a[k] for a in t))
                                    for t in (c, s)), x0[k],
                                  member=gas[k], **kw)
        assert int(one.iters) == int(got.iters[k])
        np.testing.assert_allclose(float(one.deff), float(got.deff[k]),
                                   rtol=1e-12)


# ------------------------------------------------------------ dmg


@pytest.mark.parametrize("use_pallas", [True, "tiled"])
def test_solve_dmg_matches_jax_fused_cycles(use_pallas):
    c, s, x0, gas = _system(_blob_image(1))
    kw = dict(tol=1e-10, max_iter=300, use_pallas=use_pallas)
    ref = jdmg.solve_dmg(_to_jax(c), _to_jax(s), jnp.asarray(x0.numpy()),
                         member=gas, pallas_interpret=True, **kw)
    got = dmg.solve_dmg(c, s, x0, member=gas, **kw)
    assert float(got.conv) <= 1e-10 and float(ref.conv) <= 1e-10
    assert abs(int(got.iters) - int(ref.iters)) <= 10
    np.testing.assert_allclose(float(got.deff), float(ref.deff), rtol=1e-7)


def test_solve_dmg_batched_matches_single_solves():
    imgs = [_blob_image(1), _blob_image(2, blobs=3), _blob_image(4, blobs=0)]
    systems = [_system(im) for im in imgs]
    c = fvm.StencilCoeffs(*(torch.stack(f) for f in zip(*(t[0]
                                                           for t in systems))))
    s = type(systems[0][1])(*(torch.stack(f) for f in zip(
        *(t[1] for t in systems))))
    x0 = torch.stack([t[2] for t in systems])
    gas = np.stack([t[3] for t in systems])
    kw = dict(tol=1e-10, max_iter=300, check_every=10)
    for use_pallas in (True, "tiled"):
        got = dmg.solve_dmg_batched(c, s, x0, members=gas,
                                    use_pallas=use_pallas, **kw)
        assert np.all(got.conv.numpy() <= 1e-10)
        for k, (ck, sk, xk, gk) in enumerate(systems):
            one = dmg.solve_dmg(ck, sk, xk, member=gk, use_pallas=use_pallas,
                                **kw)
            assert int(one.iters) == int(got.iters[k])
            np.testing.assert_allclose(float(one.deff), float(got.deff[k]),
                                       rtol=1e-8)
    assert len(set(got.iters.tolist())) > 1          # frozen apart
    via = dispatch.solve_batched("dmg", c, s, x0, members=gas, omega=0.0,
                                 **kw)
    assert torch.equal(via.x, dmg.solve_dmg_batched(c, s, x0, members=gas,
                                                    **kw).x)


def test_solve_dmg_refined_converges():
    c, s, x0, gas = _system(_blob_image(3))
    # conv is the raw f64 system's relative residual, whose floor on this
    # contrast-1e6 medium lies near 3e-10
    res = dmg.solve_dmg_refined(c, s, x0, tol=1e-9, member=gas)
    assert float(res.conv) <= 1e-9
    direct = dmg.solve_dmg(c, s, x0, tol=1e-10, member=gas)
    np.testing.assert_allclose(float(res.deff), float(direct.deff),
                               rtol=1e-8)
    assert int(res.iters) > 0


def test_dmg_engine_auto_rule():
    f32, f64 = torch.float32, torch.float64
    auto = dmg._dmg_engine_auto
    assert auto((2048, 2048), f32, 2) == "tiled"
    assert auto((2007, 1002), f32, 2) == "tiled"
    assert auto((1024, 1024), f32, 2) is True
    assert auto((48, 48), f32, 2) is True
    assert auto((2048, 2048), f64, 2) is True      # precond_f32=False: K2
    assert auto((2048, 2048), f32, 8) == "tiled"
    assert auto((2048, 2048), f32, 9) is False     # the plain torch cycle
    assert auto((48, 48), f64, 9) is False


def test_dmg_refusals():
    c, s, x0, gas = _system(_blob_image(1, n=16, blobs=2))
    # use_pallas=False, refused before the plain cycle was ported, runs it
    # (against the JAX package: tests/test_torch_general_cycle.py)
    kw = dict(member=gas, tol=1e-10, max_iter=300)
    plain = dmg.solve_dmg(c, s, x0, use_pallas=False, **kw)
    k2 = dmg.solve_dmg(c, s, x0, use_pallas=True, **kw)
    assert float(plain.conv) <= 1e-10
    np.testing.assert_allclose(float(plain.deff), float(k2.deff), rtol=1e-7)
    with pytest.raises(ValueError, match="f64"):
        dmg.solve_dmg(fvm.StencilCoeffs(*(a.float() for a in c)), s,
                      x0.float())
    with pytest.raises(TypeError, match="unknown dmg options"):
        dmg.solve_dmg(c, s, x0, pallas_interpret=True)
