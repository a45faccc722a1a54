"""The port's auxiliary modules on the CPU: solve checkpoints
(``utils/checkpoint.py``), the run manifest, trace and benchmark helpers
(``utils/profiling.py``), the debug checks (``utils/debug.py``), the CMAP
readers and plots (``viz.py``) and the ``entry()`` twin (``entry.py``).

Counterparts of the JAX package's ``TestCheckpoint``, ``TestManifest``
(``tests/test_volume.py``) and ``TestDebugUtils``
(``tests/test_operators.py``), plus checkpoints crossing between the two
packages in both directions (the same npz layout) and the entry step
against the JAX ``__graft_entry__.entry()`` (float32).
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu.ops import fvm as jfvm
from effectivediffusivityfvm_tpu.ops.flux import make_flux_spec as j_spec
from effectivediffusivityfvm_tpu.solvers.jacobi import \
    solve_jacobi as j_solve_jacobi
from effectivediffusivityfvm_tpu.utils import checkpoint as jckpt
from effectivediffusivityfvm_tpu.utils.debug import \
    check_finite as j_check_finite
from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
from effectivediffusivityfvm_tpu_torch.io import writers
from effectivediffusivityfvm_tpu_torch.ops import fvm
from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
from effectivediffusivityfvm_tpu_torch.solvers.driver import SolveResult
from effectivediffusivityfvm_tpu_torch.solvers.jacobi import solve_jacobi
from effectivediffusivityfvm_tpu_torch.solvers.multigrid import solve_mgcg
from effectivediffusivityfvm_tpu_torch.utils.checkpoint import (
    AsyncSaver, checkpointed_solve, load_state, save_state)
from effectivediffusivityfvm_tpu_torch.utils.debug import (check_finite,
                                                           debug_context,
                                                           nan_guard)
from effectivediffusivityfvm_tpu_torch.utils.profiling import (
    RunManifest, benchmark_solver, trace)
from effectivediffusivityfvm_tpu_torch.viz import (plot_concentration,
                                                   plot_volume_slices,
                                                   read_cmap, read_cmap_3d)

torch.set_num_threads(1)


def _system(d):
    dt = torch.tensor(d)
    ny, nx = d.shape
    x0 = (torch.arange(nx, dtype=torch.float64) / nx).expand(ny, nx)
    return fvm.fvm_coefficients(dt, 0.0, 1.0), make_flux_spec(dt, 0.0, 1.0), x0


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        x = torch.tensor(np.random.default_rng(0).random((8, 8)))
        p = str(tmp_path / "ck.npz")
        save_state(p, x, iters=123, meta={"deff": torch.tensor(0.25)})
        x2, it, meta = load_state(p)
        np.testing.assert_array_equal(x2, x.numpy())
        assert it == 123 and float(meta["deff"]) == 0.25
        assert load_state(str(tmp_path / "missing.npz")) is None
        assert not glob.glob(str(tmp_path / "*.tmp"))

    def test_checkpointed_solve_resumes(self, tmp_path):
        d = np.exp(np.random.default_rng(42).uniform(0, np.log(100), (12, 12)))
        c, spec, x0 = _system(d)
        p = str(tmp_path / "solve.npz")
        kw = dict(tol=1e-10, check_every=50, criterion="residual")
        res = checkpointed_solve(solve_jacobi, c, spec, x0,
                                 checkpoint_path=p, segment_iters=500,
                                 max_iter=100_000, **kw)
        assert os.path.exists(p)
        ref = solve_jacobi(c, spec, x0, max_iter=100_000, **kw)
        np.testing.assert_allclose(float(res.deff), float(ref.deff),
                                   rtol=1e-8)
        assert res.x.dtype == x0.dtype and res.x.device == x0.device

        # a rerun resumes from the converged checkpoint and finishes at once
        res2 = checkpointed_solve(solve_jacobi, c, spec, x0,
                                  checkpoint_path=p, segment_iters=500,
                                  max_iter=100_000, **kw)
        np.testing.assert_allclose(float(res2.deff), float(ref.deff),
                                   rtol=1e-8)
        assert int(res2.iters) == int(res.iters)
        assert res2.x.dtype == x0.dtype

    def test_checkpointed_mgcg(self, tmp_path):
        d = np.exp(np.random.default_rng(1).uniform(0, np.log(100), (16, 16)))
        c, spec, x0 = _system(d)
        kw = dict(tol=1e-10, check_every=5, criterion="relresidual")
        res = checkpointed_solve(solve_mgcg, c, spec, x0,
                                 checkpoint_path=str(tmp_path / "mg.npz"),
                                 segment_iters=5, max_iter=200, **kw)
        ref = solve_mgcg(c, spec, x0, max_iter=200, **kw)
        assert float(res.conv) <= 1e-10
        np.testing.assert_allclose(float(res.deff), float(ref.deff),
                                   rtol=1e-9)

    def test_protocol_carry_matches_unsegmented(self, tmp_path):
        """With protocol_carry, a segmented reference-protocol (criterion
        'deff') Jacobi run stops at exactly the sweep where one continuous
        run stops: same iters, same Deff, same field; a fresh call against
        the same checkpoint (kill and resume) finishes alike."""
        rng = np.random.default_rng(42)
        d = np.where(rng.random((16, 16)) < 0.5, 1.0, 0.05)
        c, spec, x0 = _system(d)
        kw = dict(tol=1e-7, check_every=50, criterion="deff")
        ref = solve_jacobi(c, spec, x0, max_iter=100_000, **kw)
        assert 50 < int(ref.iters) < 100_000

        p = str(tmp_path / "pc.npz")
        seg = checkpointed_solve(solve_jacobi, c, spec, x0,
                                 checkpoint_path=p, segment_iters=151,
                                 max_iter=100_000, protocol_carry=True, **kw)
        assert int(seg.iters) == int(ref.iters)
        np.testing.assert_allclose(float(seg.deff), float(ref.deff), rtol=0)
        torch.testing.assert_close(seg.x, ref.x, rtol=0, atol=0)

        seg2 = checkpointed_solve(solve_jacobi, c, spec, x0,
                                  checkpoint_path=p, segment_iters=151,
                                  max_iter=100_000, protocol_carry=True,
                                  **kw)
        np.testing.assert_allclose(float(seg2.deff), float(ref.deff), rtol=0)

    def test_protocol_carry_resumes_an_interrupted_run(self, tmp_path):
        """Killed after a budget of 302 sweeps (two segments), the run
        resumed with the full budget stops where the continuous one does."""
        rng = np.random.default_rng(42)
        d = np.where(rng.random((16, 16)) < 0.5, 1.0, 0.05)
        c, spec, x0 = _system(d)
        kw = dict(tol=1e-7, check_every=50, criterion="deff")
        ref = solve_jacobi(c, spec, x0, max_iter=100_000, **kw)
        p = str(tmp_path / "kill.npz")
        part = checkpointed_solve(solve_jacobi, c, spec, x0,
                                  checkpoint_path=p, segment_iters=151,
                                  max_iter=302, protocol_carry=True, **kw)
        assert int(part.iters) == 302 < int(ref.iters)
        full = checkpointed_solve(solve_jacobi, c, spec, x0,
                                  checkpoint_path=p, segment_iters=151,
                                  max_iter=100_000, protocol_carry=True, **kw)
        assert int(full.iters) == int(ref.iters)
        np.testing.assert_allclose(float(full.deff), float(ref.deff), rtol=0)
        torch.testing.assert_close(full.x, ref.x, rtol=0, atol=0)

    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_checkpoints_cross_packages(self, tmp_path, writer):
        x = np.random.default_rng(3).random((6, 10))
        meta = {"deff": 0.125, "deff_old": 0.25, "converged": 1}
        p = str(tmp_path / f"{writer}.npz")
        if writer == "torch":
            save_state(p, torch.tensor(x), 77, meta=meta)
            got = jckpt.load_state(p)
        else:
            jckpt.save_state(p, jnp.asarray(x), 77, meta=meta)
            got = load_state(p)
        np.testing.assert_array_equal(got[0], x)
        assert got[1] == 77
        assert {k: float(v) for k, v in got[2].items()} == meta

    def test_jax_checkpoint_resumed_by_the_port(self, tmp_path):
        """A solve the JAX package checkpointed after one segment finishes
        in the port at the sweep where the port's continuous run stops."""
        rng = np.random.default_rng(42)
        d = np.where(rng.random((16, 16)) < 0.5, 1.0, 0.05)
        kw = dict(tol=1e-7, check_every=50, criterion="deff")
        dj = jnp.asarray(d)
        x0j = jnp.broadcast_to(jnp.arange(16, dtype=jnp.float64) / 16,
                               (16, 16))
        p = str(tmp_path / "jax.npz")
        jckpt.checkpointed_solve(
            j_solve_jacobi, jfvm.fvm_coefficients(dj, 0.0, 1.0),
            j_spec(dj, 0.0, 1.0), x0j, checkpoint_path=p, segment_iters=151,
            max_iter=151, protocol_carry=True, **kw)
        c, spec, x0 = _system(d)
        ref = solve_jacobi(c, spec, x0, max_iter=100_000, **kw)
        res = checkpointed_solve(solve_jacobi, c, spec, x0,
                                 checkpoint_path=p, segment_iters=151,
                                 max_iter=100_000, protocol_carry=True, **kw)
        assert int(res.iters) == int(ref.iters)
        np.testing.assert_allclose(float(res.deff), float(ref.deff),
                                   rtol=1e-12)

    def test_orbax_is_not_ported(self, tmp_path):
        with pytest.raises(NotImplementedError):
            save_state(str(tmp_path / "o"), torch.zeros(2), backend="orbax")
        os.mkdir(tmp_path / "orbax_dir")
        with pytest.raises(NotImplementedError):
            load_state(str(tmp_path / "orbax_dir"))


class TestAsyncSaver:
    def test_roundtrip_and_snapshot(self, tmp_path):
        x = torch.arange(12, dtype=torch.float64).reshape(3, 4)
        paths = [str(tmp_path / f"s{i}.npz") for i in range(3)]
        with AsyncSaver() as saver:
            for i, p in enumerate(paths):
                saver.save(p, x, iters=i, meta={"deff": 0.5 * i})
                x += 1.0          # the next segment changes the field
        for i, p in enumerate(paths):
            xs, it, meta = load_state(p)
            np.testing.assert_array_equal(
                xs, np.arange(12.0).reshape(3, 4) + i)
            assert it == i and float(meta["deff"]) == 0.5 * i

    def test_wait_raises_a_failed_write(self, tmp_path):
        saver = AsyncSaver()
        saver.save(str(tmp_path / "no" / "such" / "dir.npz"), torch.zeros(2))
        with pytest.raises(OSError):
            saver.wait()
        saver.save(str(tmp_path / "ok.npz"), torch.zeros(2))
        saver.wait()
        assert load_state(str(tmp_path / "ok.npz"))[1] == 0


class TestManifest:
    def test_manifest_roundtrip(self, tmp_path):
        m = RunManifest(str(tmp_path / "run.json"))
        m.set_config(SimulationConfig())
        m.add(img=0, deff=0.5, iters=100)
        m.write()
        data = json.loads((tmp_path / "run.json").read_text())
        assert data["meta"]["config"]["n_phase"] == 2
        assert data["records"][0]["deff"] == 0.5


class TestProfiling:
    def test_trace_writes_a_chrome_trace(self, tmp_path):
        log_dir = str(tmp_path / "trace")
        with trace(log_dir) as prof:
            torch.ones(64, 64).matmul(torch.ones(64, 64))
        files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        assert len(files) == 1
        events = json.load(open(files[0]))["traceEvents"]
        assert any("mm" in e.get("name", "") for e in events)
        assert len(prof.key_averages()) > 0

    def test_benchmark_solver_keys(self):
        d = np.exp(np.random.default_rng(4).uniform(0, np.log(10), (16, 16)))
        c, spec, x0 = _system(d)
        out = benchmark_solver(solve_mgcg, c, spec, x0, repeats=2,
                               bytes_per_iter=1e6, tol=1e-8, max_iter=50)
        assert set(out) == {"seconds", "times", "iterations",
                            "effective_gbps"}
        assert len(out["times"]) == 2 and out["seconds"] == min(out["times"])
        ref = solve_mgcg(c, spec, x0, tol=1e-8, max_iter=50)
        assert out["iterations"] == int(ref.iters) > 0


class TestDebugUtils:
    def test_check_finite(self):
        check_finite({"a": torch.ones(3)})
        with pytest.raises(FloatingPointError):
            check_finite(torch.tensor([1.0, float("nan")]), "bad")
        guarded = nan_guard(lambda: torch.tensor([float("inf")]), "inf-solve")
        with pytest.raises(FloatingPointError):
            guarded()

    def test_messages_match_jax(self):
        """The same leaf numbering (dict keys sorted, NamedTuple fields in
        order) and message as the JAX package's."""
        bad = np.array([1.0, np.nan, np.inf])
        res = SolveResult(x=torch.zeros(2, 2), deff=torch.tensor(0.5),
                          conv=torch.tensor(bad), iters=torch.tensor(3))
        trees = [({"b": torch.tensor(bad), "a": torch.ones(2)},
                  {"b": jnp.asarray(bad), "a": jnp.ones(2)}),
                 ([torch.ones(1), (None, np.ones(2), torch.tensor(bad))],
                  [jnp.ones(1), (None, np.ones(2), jnp.asarray(bad))]),
                 (res, tuple(jnp.asarray(a.numpy()) for a in res))]
        for tree, jtree in trees:
            with pytest.raises(FloatingPointError) as got:
                check_finite(tree, "lbl")
            with pytest.raises(FloatingPointError) as want:
                j_check_finite(jtree, "lbl")
            assert str(got.value) == str(want.value)

    def test_debug_context_sets_and_restores_anomaly_mode(self):
        assert not torch.is_anomaly_enabled()
        with debug_context():
            assert torch.is_anomaly_enabled()
            assert torch.is_anomaly_check_nan_enabled()
            x = torch.tensor([0.0], requires_grad=True)
            with pytest.raises(RuntimeError, match="nan"):
                (torch.sqrt(x) * 0.0).sum().backward()
        assert not torch.is_anomaly_enabled()
        with debug_context(nans=False, infs=True):
            assert torch.is_anomaly_enabled()
            assert not torch.is_anomaly_check_nan_enabled()
        with debug_context(nans=False, infs=False):
            assert not torch.is_anomaly_enabled()
        assert not torch.is_anomaly_enabled()


class TestViz:
    def test_read_cmap_of_the_writer(self, tmp_path):
        field = np.random.default_rng(0).random((5, 7))
        p = str(tmp_path / "cmap.csv")
        writers.write_cmap(p, field)
        np.testing.assert_allclose(read_cmap(p), field, rtol=1e-3)

    def test_read_cmap_3d_of_the_writer(self, tmp_path):
        field = np.random.default_rng(1).random((3, 4, 5))
        p = str(tmp_path / "cmap3.csv")
        writers.write_cmap_3d(p, field)
        back = read_cmap_3d(p)
        assert back.shape == field.shape
        np.testing.assert_allclose(back, field, rtol=1e-3)

    def test_plots_to_files(self, tmp_path):
        pytest.importorskip("matplotlib")
        rng = np.random.default_rng(2)
        p2, p3 = str(tmp_path / "c2.csv"), str(tmp_path / "c3.csv")
        writers.write_cmap(p2, rng.random((6, 8)))
        writers.write_cmap_3d(p3, rng.random((4, 6, 8)))
        plot_concentration(p2, out_path=str(tmp_path / "c2.png"))
        plot_volume_slices(p3, out_path=str(tmp_path / "c3.png"))
        assert os.path.getsize(tmp_path / "c2.png") > 0
        assert os.path.getsize(tmp_path / "c3.png") > 0


def test_entry_matches_the_jax_entry():
    """The port's step equals the JAX step's sweeps run one by one (the
    fields bit for bit, Deff to the order of the float32 sums).  The JAX
    ``entry()`` runs them in a compiled ``fori_loop``, which XLA fuses
    (contracting multiplies and adds), so it lands ~5e-5 off its own sweeps
    run one by one on this float32 problem (solid cells have diag_inv
    ~3e5); against it the port is held to that gap."""
    import __graft_entry__

    from effectivediffusivityfvm_tpu.ops.flux import boundary_deff as j_deff
    from effectivediffusivityfvm_tpu_torch.entry import entry

    forward, (c, spec, x) = entry(device="cpu")
    got = forward(c, spec, x).numpy()
    assert got.shape == (4,) and got.dtype == np.float32
    jfwd, (jc, js, jx0) = __graft_entry__.entry()
    jx = jx0
    for _ in range(100):
        x = fvm.jacobi_sweep(c, x, 2.0 / 3.0)
        jx = jfvm.jacobi_sweep(jc, jx, 2.0 / 3.0)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    eager = np.asarray(j_deff(js, jx))
    np.testing.assert_allclose(got, eager, rtol=1e-6)
    compiled = np.asarray(jfwd(jc, js, jx0))
    gap = np.max(np.abs(compiled - eager) / np.abs(compiled))
    assert np.all(np.isfinite(compiled)) and gap <= 1e-4
    np.testing.assert_allclose(got, compiled, rtol=max(1e-5, 2 * gap))
