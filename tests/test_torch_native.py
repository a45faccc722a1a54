"""The port's native preprocessing bridge (``models/_native.py`` over its own
``csrc/preprocess.cpp``) and ``floodfill.participating_mask_device``
against the JAX package's, on the CPU: the library builds with ``g++``
into the checkout's ``build/native/``; flood fill, porosity and the phase
classes equal the JAX package's native and scipy routes; the device
variant equals ``flood_fill`` and the JAX one; ``flood_fill`` takes the
scipy route when the library cannot be built.  Every comparison is exact.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.models import _native as j_native
from effectivediffusivityfvm_tpu.models import floodfill as j_floodfill
from effectivediffusivityfvm_tpu.models import phases as j_phases
from effectivediffusivityfvm_tpu_torch.models import _native, floodfill

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's library, built under a temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DEFF_TPU_NATIVE_CACHE",
              str(tmp_path_factory.mktemp("jax_native")))
    yield j_native
    mp.undo()


def _masks(seed, shape=(40, 56), n=6):
    """Random solid masks around the percolation threshold, one with a
    fluid channel that joins only through the periodic Y wrap."""
    rng = np.random.default_rng(seed)
    out = [rng.random(shape) < p for p in np.linspace(0.3, 0.6, n - 1)]
    wrap = np.ones(shape, bool)
    wrap[:6, : shape[1] // 2 + 1] = False
    wrap[-6:, shape[1] // 2:] = False
    return out + [wrap]


def test_library_builds_with_gpp():
    assert shutil.which("g++") is not None
    lib = _native.get_lib()
    assert lib is not None and _native.native_available()
    path = _native._lib_path()
    assert path.exists() and path.parent == _native.BUILD_DIR
    assert path.parent.parent.name == "build"


@pytest.mark.parametrize("seed", [0, 1])
def test_flood_fill_matches_jax_routes(jax_native, seed):
    assert jax_native.native_available()
    for solid in _masks(seed):
        got = floodfill.flood_fill(solid)
        native = j_floodfill.flood_fill(solid, use_native=True)
        scipy = j_floodfill.flood_fill(solid, use_native=False)
        for want in (native, scipy):
            np.testing.assert_array_equal(got.participating,
                                          want.participating)
            np.testing.assert_array_equal(got.isolated, want.isolated)
            assert got.path_flag == want.path_flag
        port_scipy = floodfill.flood_fill(solid, use_native=False)
        np.testing.assert_array_equal(port_scipy.participating,
                                      got.participating)


def test_porosity_and_classes_match_jax(jax_native):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (33, 47)).astype(np.uint8)
    assert _native.porosity_native(img) == jax_native.porosity_native(img)
    assert _native.porosity_native(img) == float(np.mean(img < 150))
    for mine, theirs, plain in (
            (_native.classify_two_phase_native,
             jax_native.classify_two_phase_native,
             j_phases.two_phase_classes),
            (_native.classify_three_phase_native,
             jax_native.classify_three_phase_native,
             j_phases.three_phase_classes)):
        got = mine(img)
        np.testing.assert_array_equal(got, theirs(img))
        np.testing.assert_array_equal(got, plain(img))


def test_participating_mask_device_matches_flood_fill_and_jax():
    masks = _masks(5)
    got = floodfill.participating_mask_device(torch.tensor(np.stack(masks)))
    want = j_floodfill.participating_mask_device(jnp.asarray(masks[0]))
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    for k, solid in enumerate(masks):
        ff = floodfill.flood_fill(solid)
        np.testing.assert_array_equal(got[0][k].numpy(), ff.participating)
        np.testing.assert_array_equal(got[1][k].numpy(), ff.isolated)
        one = floodfill.participating_mask_device(torch.tensor(solid))
        assert bool(one[2]) == ff.path_flag
    # a cap on the spreads stops the propagation where the JAX loop stops
    for steps in (0, 3, 40):       # 40: a fixpoint test after 32 spreads
        cut = floodfill.participating_mask_device(
            torch.tensor(masks[-1]), max_steps=steps)
        ref = j_floodfill.participating_mask_device(
            jnp.asarray(masks[-1]), max_steps=steps)
        np.testing.assert_array_equal(cut[0].numpy(), np.asarray(ref[0]))
        assert bool(cut[2]) == bool(ref[2])


def test_flood_fill_without_the_library_takes_scipy(monkeypatch):
    solid = _masks(7)[2]
    want = floodfill.flood_fill(solid)
    monkeypatch.setattr(_native, "get_lib", lambda: None)
    assert not _native.native_available()
    assert _native.flood_fill_native(solid) is None
    got = floodfill.flood_fill(solid)
    np.testing.assert_array_equal(got.participating, want.participating)
    assert got.path_flag == want.path_flag
