"""The port's compacting batch solve (``solvers/compact.py``) against the
JAX package's on the CPU, in float64: ``cg`` and ``mgcg`` (the port's
"cgstep" engine against the JAX one in interpret mode) compacted on six
images, the stall guard's warning and retirement, and ``Compact: 1``
through ``batch_sim``.

The JAX package pads each sub-batch to a power-of-two bucket by repeating
an active image; the port packs exactly the active images.  Each image's
solve is independent of its batch, so the two agree image by image:
identical iterations and Deff rtol 1e-10.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu import config as jconfig
from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as j_spec
from effectivediffusivityfvm_tpu.pipeline import batch as jbatch
from effectivediffusivityfvm_tpu.solvers import cg as jcg
from effectivediffusivityfvm_tpu.solvers import compact as jcompact
from effectivediffusivityfvm_tpu.solvers import multigrid as jmg
from effectivediffusivityfvm_tpu_torch import config
from effectivediffusivityfvm_tpu_torch.io.images import parallel_slab
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.pipeline import batch
from effectivediffusivityfvm_tpu_torch.solvers import cg, compact, multigrid
from effectivediffusivityfvm_tpu_torch.solvers.driver import SolveResult

torch.set_num_threads(1)

MG_KW = dict(min_size=4, coarse_iters=8, nu1=2, nu2=2)


def _medium(seed, bsz=6, ny=24, nx=16, decades=(1.0, 1.0)):
    """Log-uniform media of graded contrast (image ``k`` spans ``a + b k``
    decades), so the images converge at different iterations and the
    active set shrinks."""
    rng = np.random.default_rng(seed)
    a, b = decades
    return np.stack([np.exp(rng.uniform(0, np.log(10.0 ** (a + b * k)),
                                        (ny, nx))) for k in range(bsz)])


def _systems(d):
    bsz, ny, nx = d.shape
    x0 = np.broadcast_to(np.arange(nx) / nx, (bsz, ny, nx))
    dj = jnp.asarray(d)
    jsys = (jax.vmap(jfvm.fvm_coefficients, in_axes=(0, None, None))(
        dj, 0.0, 1.0), jax.vmap(j_spec, in_axes=(0, None, None))(dj, 0.0, 1.0),
        jnp.asarray(x0))
    dt = torch.tensor(d)
    tsys = (fvm.fvm_coefficients(dt, 0.0, 1.0), make_flux_spec(dt, 0.0, 1.0),
            torch.tensor(x0))
    return jsys, tsys


# per solver: JAX and port solvers and keywords, the media's decades
# (diagonal-PCG runs 200-530 iterations on 0.5-3 decades; on more, its
# iterates at the rounding floor part from the JAX ones after ~500
# iterations), the iteration cap
SOLVERS = {
    "cg": (jcg.solve_cg_batched, cg.solve_cg_batched, {}, {}, (0.5, 0.5),
           600),
    "mgcg": (jmg.solve_mgcg_batched, multigrid.solve_mgcg_batched,
             dict(MG_KW, use_pallas="cgstep", pallas_interpret=True),
             dict(MG_KW, use_pallas="cgstep"), (1.0, 1.0), 200),
}


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_compacted_matches_jax(solver):
    jfn, tfn, jkw, tkw, decades, cap = SOLVERS[solver]
    jsys, tsys = _systems(_medium(1, decades=decades))
    kw = dict(tol=1e-9, max_iter=cap, check_every=10, criterion="residual",
              segment=30)
    want = jcompact.solve_batched_compacted(jfn, *jsys, **kw, **jkw)
    got = compact.solve_batched_compacted(tfn, *tsys, **kw, **tkw)
    it = got.iters.numpy()
    np.testing.assert_array_equal(it, np.asarray(want.iters))
    assert len(set(it.tolist())) > 2          # the active set shrank
    assert np.all(got.conv.numpy() <= 1e-9)
    np.testing.assert_allclose(got.deff.numpy(), np.asarray(want.deff),
                               rtol=1e-10)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-9, atol=1e-12)


def test_compacted_matches_unsegmented_mgcg():
    _, tsys = _systems(_medium(2, bsz=4))
    kw = dict(tol=1e-9, max_iter=300, check_every=10, criterion="residual",
              use_pallas="cgstep", **MG_KW)
    ref = multigrid.solve_mgcg_batched(*tsys, **kw)
    got = compact.solve_batched_compacted(multigrid.solve_mgcg_batched,
                                          *tsys, segment=20, **kw)
    assert np.all(got.conv.numpy() <= 1e-9)
    np.testing.assert_allclose(got.deff.numpy(), ref.deff.numpy(),
                               rtol=1e-7)
    assert np.all(got.iters.numpy() <= ref.iters.numpy() + 20)


def _cycling(calls):
    def solve(coeffs, spec, x, *, tol, max_iter, check_every, criterion,
              **kw):
        # uses its whole segment every time, conv stuck above tol
        nb = x.shape[0]
        calls.append(nb)
        return SolveResult(x=x, deff=torch.full((nb,), 0.5),
                           conv=torch.full((nb,), 1e-3),
                           iters=torch.full((nb,), max_iter,
                                            dtype=torch.int32))
    return solve


@pytest.mark.parametrize("criterion, retired", [("residual", True),
                                                ("deff", False)])
def test_stall_guard_retires_the_limit_cycle(criterion, retired):
    calls = []
    x0 = torch.zeros((2, 8, 8))
    dummy = torch.ones((2,))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = compact.solve_batched_compacted(
            _cycling(calls), dummy, dummy, x0, tol=1e-9, max_iter=200,
            segment=20, check_every=10, criterion=criterion,
            stall_segments=3)
    warned = any(issubclass(w.category, RuntimeWarning)
                 and "limit cycle" in str(w.message) for w in rec)
    assert warned is retired
    # one improvement (inf -> 1e-3), then three stalled segments; the
    # "deff" monitor has no guard and runs to max_iter
    want = 4 * 20 if retired else 200
    np.testing.assert_array_equal(got.iters.numpy(), [want, want])
    assert calls == [2] * (want // 20)
    np.testing.assert_allclose(got.conv.numpy(), [1e-3, 1e-3], rtol=1e-7)


def _cfg(mod, tmp_path, name, solver, **kw):
    return mod.SimulationConfig(
        n_phase=2, batch_flag=True, d_fluid=1.0, d_solid=0.1,
        convergence=1e-8, max_iter=2000, check_every=10, dtype="float64",
        criterion="residual", solver=solver, num_images=3,
        incremental_output=False, output_name=str(tmp_path / name),
        **dict(dict(compact_batches=True), **kw))


@pytest.mark.parametrize("solver", ["cg", "mgcg"])
def test_compact_batch_sim_matches_jax(tmp_path, solver):
    imgs = [parallel_slab(24, e) for e in (0.25, 0.5, 0.75)]
    imgs[1] = imgs[1].T.copy()                  # a harder, series medium
    # the JAX mgcg in interpret mode runs the "cgstep" engine the port's
    # Pallas: force runs
    jkw, tkw = (({"pallas": "interpret"}, {"pallas": "force"})
                if solver == "mgcg" else ({}, {}))
    want = jbatch.batch_sim(_cfg(jconfig, tmp_path, "a.csv", solver, **jkw),
                            imgs=imgs)
    got = batch.batch_sim(_cfg(config, tmp_path, "b.csv", solver, **tkw),
                          imgs=imgs, device="cpu")
    cols = [0, 1, 2, 5, 7, 8]          # all but Deff, time and conv
    np.testing.assert_array_equal(got[:, cols], want[:, cols])
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=1e-10)
    # the residuals at stop lie near the rounding floor: both below tol
    assert np.all(got[:, 6] <= 1e-8) and np.all(want[:, 6] <= 1e-8)
    # against the unsegmented batch: both stop at residual 1e-8, where the
    # series medium's Deff is good to ~1e-6
    plain = batch.batch_sim(_cfg(config, tmp_path, "c.csv", solver,
                                 **dict(tkw, compact_batches=False)),
                            imgs=imgs, device="cpu")
    np.testing.assert_allclose(got[:, 3], plain[:, 3], rtol=1e-5)


def test_an_image_paused_in_its_segment_is_resumed():
    """The fused engine can pause an image in the kernel (recurrence
    residual below tol) in a segment's last window while its true residual
    is above tol: it stopped early but has not converged.  Compaction
    resumes it while its conv improves (the JAX package retires it there),
    and retires an image that stopped early without improving (the
    divergence net)."""
    convs = {0: iter([1e-4, 1e-6, 1e-10]), 1: iter([1e-3, 1e-3, 1e-3])}
    calls = []

    def paused_solve(coeffs, spec, x, *, tol, max_iter, check_every,
                     criterion, **kw):
        ids = coeffs.tolist()
        calls.append(ids)
        conv = torch.tensor([next(convs[int(i)]) for i in ids])
        return SolveResult(x=x, deff=torch.full((len(ids),), 0.5), conv=conv,
                           iters=torch.full((len(ids),), 7,
                                            dtype=torch.int32))

    ids = torch.tensor([0.0, 1.0])
    got = compact.solve_batched_compacted(
        paused_solve, ids, ids, torch.zeros((2, 4, 4)), tol=1e-9,
        max_iter=1000, segment=20, check_every=10, criterion="residual")
    assert calls == [[0.0, 1.0], [0.0, 1.0], [0.0]]
    np.testing.assert_array_equal(got.iters.numpy(), [21, 14])
    np.testing.assert_allclose(got.conv.numpy(), [1e-10, 1e-3], rtol=1e-6)
