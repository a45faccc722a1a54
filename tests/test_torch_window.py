"""The CG windows of K1, K5 and K7 end where the JAX ``while_loop`` ends
them: at the first iteration that starts with no live image.

Each case gives every image a stop threshold it crosses inside the window
(``stop = f sum|r_in|``), so the JAX loop, run in interpret mode on the
CPU, leaves early; its iterations are ``max(k_done)`` (each live image
counts every iteration, and the last one has a live image).  The port's
plain versions must return the same ``k_done`` and run exactly that many
iterations (``<fn>.iterations``).  The fields are the other tests' job
(tests/test_torch_kernels.py, test_torch_tiled.py, test_torch_3d.py);
here they are held to the same rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops import fvm3d as jfvm3d
from effectivediffusivityfvm_tpu.ops.kernels.cgstep3d import \
    cg_steps3d_tiled as j_cg_steps3d
from effectivediffusivityfvm_tpu.ops.kernels.cgstep_tiled import \
    cg_steps_tiled as j_cg_steps_tiled
from effectivediffusivityfvm_tpu.ops.kernels.cgstep_vmem import \
    cg_steps_pallas
from effectivediffusivityfvm_tpu_torch.ops import fvm as tfvm
from effectivediffusivityfvm_tpu_torch.ops import fvm3d as tfvm3d
from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle3d as tv3
from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle_tiled as tvt
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import \
    cg_steps_reference
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep3d import \
    cg_steps3d_reference
from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import \
    cg_steps_tiled_reference
from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import \
    v_cycle_reference
from effectivediffusivityfvm_tpu_torch.solvers import multigrid, solvers3d

torch.set_num_threads(1)
K = 6
# per image, the share of sum|r_in| at which it stops: the first image dies
# after one or two iterations, the second a little later
STOP = np.array([0.3, 0.02])


def _d(seed, shape, contrast=1e3):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(0, np.log(contrast), shape))


def _thresholds(r, axes):
    sr0 = np.sum(np.abs(r), axis=axes)
    return np.ones(2), STOP * sr0, np.full(2, 1e300)


def _check(got_kdone, want_kdone, fn, before):
    want = np.asarray(want_kdone).ravel()
    assert got_kdone.tolist() == want.tolist()
    assert 1 <= want.max() < K and want.min() >= 1     # all die mid-window
    assert fn.iterations - before == want.max()


def test_plain_k1_window_ends_with_the_jax_loop():
    d = _d(3, (2, 16, 24))
    c = tfvm.fvm_coefficients(torch.tensor(d), 0.0, 1.0)
    lv = multigrid.build_hierarchy(c, min_size=4, pad_levels=True)
    jlv = [jfvm.StencilCoeffs(*(jnp.asarray(a.numpy()) for a in l))
           for l in lv]
    mg = dict(omega=(1.281, 0.5584), nu=2, coarse_iters=8, over=1.8)
    x = np.zeros(tuple(lv[0].diag.shape))
    r = lv[0].b.numpy().copy()
    p = v_cycle_reference(lv, lv[0].b, **mg).numpy()
    rz = np.sum(r * p, axis=(1, 2))
    active, stop, hi = _thresholds(r, (1, 2))
    state = (x, r, p, rz, active, stop, hi)
    out = cg_steps_pallas(
        jlv, *(jnp.asarray(a) for a in state[:3]),
        *(jnp.asarray(a)[:, None] for a in state[3:]),
        jnp.asarray(K, jnp.int32), interpret=True, refresh=True, **mg)
    before = cg_steps_reference.iterations
    got = cg_steps_reference(lv, *(torch.tensor(a) for a in state), K, **mg)
    _check(got[4], out[4], cg_steps_reference, before)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out[0]),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("mode", ["stored", "matrix-free"])
def test_plain_k5_window_ends_with_the_jax_loop(mode):
    d = _d(4, (2, 32, 24))
    c = tfvm.fvm_coefficients(torch.tensor(d), 0.0, 1.0)
    lv, mf = multigrid.tiled_system(c, torch.tensor(d), min_size=4)
    jlv = [jfvm.StencilCoeffs(*(jnp.asarray(a.numpy()) for a in l))
           for l in lv]
    mg = dict(omega=(1.281, 0.5584), nu=2, coarse_iters=8, over=1.8)
    x = np.zeros(tuple(lv[0].diag.shape))
    r = lv[0].b.numpy().copy()
    p = tvt.v_cycle_tiled_reference(lv, lv[0].b, **mg).numpy()
    rz = np.sum(r * p, axis=(1, 2))
    active, stop, hi = _thresholds(r, (1, 2))
    state = (x, r, p, rz, active, stop, hi)
    extra = {} if mode == "stored" else mf
    jextra = ({} if mode == "stored" else
              dict(d_field=jnp.asarray(mf["d_field"].numpy()),
                   geom=mf["geom"]))
    out = j_cg_steps_tiled(
        jlv, *(jnp.asarray(a) for a in state[:3]),
        *(jnp.asarray(a)[:, None] for a in state[3:]),
        jnp.asarray(K, jnp.int32), band=8, interpret=True, **mg, **jextra)
    before = cg_steps_tiled_reference.iterations
    got = cg_steps_tiled_reference(lv, *(torch.tensor(a) for a in state), K,
                                   **mg, **extra)
    _check(got[4], out[4], cg_steps_tiled_reference, before)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out[0]),
                               rtol=1e-10, atol=0)


@pytest.mark.parametrize("mode", ["stored", "matrix-free"])
def test_plain_k7_window_ends_with_the_jax_loop(mode):
    d = _d(5, (2, 16, 10, 11))
    c = tfvm3d.fvm_coefficients_3d(torch.tensor(d), 0.0, 1.0)
    lv, mf = solvers3d.tiled3d_system(c, torch.tensor(d), min_size=2)
    jlv = [jfvm3d.StencilCoeffs3D(*(jnp.asarray(a.numpy()) for a in l))
           for l in lv]
    mg = dict(omega=0.8, nu=2, coarse_iters=5, over=1.8)
    x = np.zeros(tuple(lv[0].diag.shape))
    r = lv[0].b.numpy().copy()
    p = tv3.v_cycle3d_tiled_reference(lv, lv[0].b, **mg).numpy()
    rz = np.sum(r * p, axis=(1, 2, 3))
    active, stop, hi = _thresholds(r, (1, 2, 3))
    state = (x, r, p, rz, active, stop, hi)
    extra = {} if mode == "stored" else mf
    jextra = ({} if mode == "stored" else
              dict(d_field=jnp.asarray(mf["d_field"].numpy()),
                   geom=mf["geom"]))
    out = j_cg_steps3d(jlv, *(jnp.asarray(a) for a in state[:3]),
                       *(jnp.asarray(a)[:, None] for a in state[3:]), K,
                       band=8, interpret=True, **mg, **jextra)
    before = cg_steps3d_reference.iterations
    got = cg_steps3d_reference(lv, *(torch.tensor(a) for a in state), K,
                               **mg, **extra)
    _check(got[4], out[4], cg_steps3d_reference, before)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(out[0]),
                               rtol=1e-10, atol=0)

