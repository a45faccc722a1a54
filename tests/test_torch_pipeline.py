"""The port's reference CLI path against the JAX package on the CPU, in
float64: configuration, writers, flood fill, the four pipelines for the
``jacobi`` and ``jacobi_pallas`` solvers, and ``cli.main`` end to end; then
the analytic slabs through the port alone.

Both packages run the same solves with the same schedules, so iteration
counts are identical and Deff agrees to rounding (rtol 1e-9); the CSVs
agree byte for byte except the Time column.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from effectivediffusivityfvm_tpu import cli as jcli
from effectivediffusivityfvm_tpu import config as jconfig
from effectivediffusivityfvm_tpu.io import writers as jwriters
from effectivediffusivityfvm_tpu.models import floodfill as jfloodfill
from effectivediffusivityfvm_tpu.pipeline import batch as jbatch
from effectivediffusivityfvm_tpu.pipeline import single as jsingle
from effectivediffusivityfvm_tpu_torch import cli, config
from effectivediffusivityfvm_tpu_torch.convert import config_from_fields
from effectivediffusivityfvm_tpu_torch.io import images, writers
from effectivediffusivityfvm_tpu_torch.models import floodfill
from effectivediffusivityfvm_tpu_torch.pipeline import batch, single

# Grids here are tiny: torch's intra-op thread pool gains nothing on them,
# and its threads would compete for cores with the other test workers.
torch.set_num_threads(1)

INPUT_TXT = """Phases: 3
Ds: 1e-3
Df: 2
Dg: 40
MeshAmpX: 2
MeshAmpY: 3
InputName: img.png
CR: 1
CL: 0.25
OutputName: out.csv
printCMap: 1
CMapName: cmap.csv
Convergence: 1e-7
MaxIter: 2.5e4
Verbose: 0
RunBatch: 1
NumImages: 4
Dtype: float64
Solver: jacobi_pallas
CheckEvery: 300
Omega: 0.6
Criterion: relresidual
ImageDir: imgs
BatchSize: 2
Compact: 0
Devices: 1
DP: 0
SP: 1
Pallas: force
FirstWindow: 5
Unknown: 7
"""


def _img2(seed, n=32):
    """A 2-phase image: smoothed noise, 40% solid (255)."""
    rng = np.random.default_rng(seed)
    noise = ndimage.gaussian_filter(rng.standard_normal((n, n)), 2.0,
                                    mode="wrap")
    return ((noise >= np.quantile(noise, 0.6)) * 255).astype(np.uint8)


def _img3(seed, n=32):
    """A 3-phase image: a quarter gas (0), half fluid (150), solid (255)."""
    rng = np.random.default_rng(seed)
    noise = ndimage.gaussian_filter(rng.standard_normal((n, n)), 2.0,
                                    mode="wrap")
    lo, hi = np.quantile(noise, [0.25, 0.75])
    return np.where(noise < lo, 0,
                    np.where(noise < hi, 150, 255)).astype(np.uint8)


def _rows(path, time_col):
    """CSV lines with the Time column dropped."""
    out = []
    for line in open(path).read().splitlines():
        cells = line.split(",")
        del cells[time_col]
        out.append(cells)
    return out


def test_parse_input_file_matches_jax(tmp_path):
    path = tmp_path / "input.txt"
    path.write_text(INPUT_TXT)
    ref = dataclasses.asdict(jconfig.parse_input_file(str(path)))
    got = config.parse_input_file(str(path))
    assert dataclasses.asdict(got) == ref
    assert dataclasses.asdict(config_from_fields(ref)) == ref
    assert config.format_options(got) == jconfig.format_options(
        jconfig.SimulationConfig(**ref))
    assert dataclasses.asdict(config.SimulationConfig()) == dataclasses.asdict(
        jconfig.SimulationConfig())
    path.write_text("Solver: multigrid\n")
    with pytest.raises(ValueError):
        config.parse_input_file(str(path))


def test_writers_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(3)
    field = rng.random((5, 7))
    vol = rng.random((2, 3, 4))
    rows2 = [(i, rng.random(), i % 2, rng.random(), rng.random(), 1024,
              rng.random() * 1e-5, 1e-6, 1.0) for i in range(3)]
    rows3 = [(i, rng.random(), rng.random(), 1, rng.random() * 1e3,
              rng.random(), 1024, rng.random() * 1e-5, 0.0, 1.0, 200.0)
             for i in range(3)]

    def write_all(mod, d):
        d.mkdir()
        for _ in range(2):   # append mode: a header on every call
            mod.write_single(d / "s.csv", "img.png", 0.4, True, 0.25, 1.5,
                             1024, 3e-6, 1e-6, 1.0)
            mod.write_single_3phase(d / "s3.csv", "img.png", 0.25, 0.5, False,
                                    51.5, 2.0, 1600, 2e-9, 0.0, 1.0, 200.0)
        mod.write_batch(d / "b.csv", rows2)
        mod.write_batch_3phase(d / "b3.csv", rows3)
        mod.write_cmap(d / "c.csv", field)
        mod.write_cmap_3d(d / "c3.csv", vol)
        for three, rows in ((False, rows2), (True, rows3)):
            name = str(d / f"inc{int(three)}.csv")
            w = mod.IncrementalBatchWriter(name, three_phase=three)
            w.write_row(rows[2])
            # a new session resumes: it finds image 2 done, writes a header
            # again and the rest
            w = mod.IncrementalBatchWriter(name, three_phase=three)
            assert w.completed() == {2}
            for row in rows[:2]:
                w.write_row(row)
            assert w.completed() == {0, 1, 2}

    write_all(jwriters, tmp_path / "jax")
    write_all(writers, tmp_path / "torch")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    for name in names:
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def _periodic_y_path():
    """Fluid only along a path that reaches the right column by wrapping
    through the bottom and top rows; plus an isolated pore."""
    img = np.full((12, 10), True)
    img[6, 0:4] = False      # from the left column ...
    img[6:, 3] = False       # ... down to the bottom row,
    img[:3, 3] = False       # ... wraps to the top row,
    img[2, 3:] = False       # ... and on to the right column
    img[9, 7] = False        # isolated
    return img


@pytest.mark.parametrize("case", range(5))
def test_flood_fill_matches_jax_scipy_path(case):
    if case == 0:
        solid = _periodic_y_path()
    else:
        rng = np.random.default_rng(case)
        solid = rng.random((20 + case, 30 - case)) < 0.3 + 0.08 * case
    ref = jfloodfill.flood_fill(solid, use_native=False)
    got = floodfill.flood_fill(solid)
    np.testing.assert_array_equal(got.participating, ref.participating)
    np.testing.assert_array_equal(got.isolated, ref.isolated)
    assert got.path_flag == ref.path_flag
    if case == 0:
        assert got.path_flag and got.isolated.sum() == 1


def _cfg(mod, tmp_path, n_phase, solver, **kw):
    base = dict(n_phase=n_phase, d_fluid=1.0, d_solid=1e-2, d_gas=20.0,
                convergence=1e-4, max_iter=50_000, check_every=200,
                dtype="float64", criterion="residual", solver=solver,
                output_name=str(tmp_path / f"{mod.__name__.split('.')[0]}.csv"))
    base.update(kw)
    return mod.SimulationConfig(**base)


def _recorder(mod, name, log):
    fn = getattr(mod, name)

    def run(*a, **kw):
        out = fn(*a, **kw)
        log.append(np.asarray(out[2]))          # iterations
        return out
    return run


@pytest.mark.parametrize("solver", ["jacobi", "jacobi_pallas"])
@pytest.mark.parametrize("mode", ["single", "single_3phase", "batch",
                                  "batch_3phase"])
def test_pipelines_match_jax(tmp_path, monkeypatch, mode, solver):
    n_phase = 3 if mode.endswith("3phase") else 2
    make = _img3 if n_phase == 3 else _img2
    time_col = 5 if n_phase == 3 else 4
    results = {}
    # the batch runs take the DCG ladder through one pre-stage (Dg = 20);
    # the single runs solve at Dg = 5 directly (fewer JAX compilations)
    d_gas = 20.0 if mode.startswith("batch") else 5.0
    for mod, pipe in ((jconfig, jbatch if mode.startswith("batch") else jsingle),
                      (config, batch if mode.startswith("batch") else single)):
        cfg = _cfg(mod, tmp_path, n_phase, solver, d_gas=d_gas)
        kw = {} if mod is jconfig else {"device": "cpu"}
        fn = getattr(pipe, f"{mode.split('_')[0]}_sim"
                     + ("_3phase" if n_phase == 3 else ""))
        if mode.startswith("batch"):
            cfg.batch_flag, cfg.num_images = True, 2
            log = []
            group = "solve_image_group" + ("_3phase" if n_phase == 3 else "")
            monkeypatch.setattr(pipe, group, _recorder(pipe, group, log))
            out = fn(cfg, imgs=[make(1), make(2)], **kw)
            results[mod] = (out[:, time_col - 1], np.concatenate(log))
        else:
            res = fn(cfg, img=make(1), **kw)
            results[mod] = (np.array([res.deff]), np.array([res.iters]))
        results[mod] += (_rows(cfg.output_name, time_col),)
    (ref_deff, ref_it, ref_rows), (deff, it, rows) = (results[jconfig],
                                                      results[config])
    np.testing.assert_array_equal(it, ref_it)
    assert it.min() > 200                      # several check windows ran
    np.testing.assert_allclose(deff, ref_deff, rtol=1e-9)
    assert rows == ref_rows


def _write_png(path, img):
    # PNG content, whatever the name says: PIL reads by content, and a
    # lossless image keeps the phase thresholds exact
    Image.fromarray(img).save(path, format="PNG")


def test_cli_matches_jax_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for i in range(2):
        _write_png(tmp_path / f"{i:05d}.jpg", _img2(10 + i))
    _write_png(tmp_path / "one.png", _img2(5))
    runs = {
        "batch": ("Phases: 2\nRunBatch: 1\nNumImages: 2\nDs: 1e-2\n", 4),
        "single": ("Phases: 2\nInputName: one.png\nDs: 1e-2\n"
                   "printCMap: 1\n", 4),
    }
    common = ("Dtype: float64\nSolver: jacobi_pallas\nCheckEvery: 200\n"
              "Criterion: residual\nConvergence: 1e-4\n")
    for name, (text, time_col) in runs.items():
        for tag, main, kw in (("jax", jcli.main, {}),
                              ("torch", cli.main, {"device": "cpu"})):
            (tmp_path / f"{name}_{tag}.txt").write_text(
                text + common + f"OutputName: {name}_{tag}.csv\n"
                f"CMapName: {name}_{tag}.cmap\n")
            assert main([f"{name}_{tag}.txt"], **kw) == 0
        rows = _rows(tmp_path / f"{name}_torch.csv", time_col)
        assert rows == _rows(tmp_path / f"{name}_jax.csv", time_col)
        assert len(rows) == (3 if name == "batch" else 2)
    assert ((tmp_path / "single_torch.cmap").read_bytes()
            == (tmp_path / "single_jax.cmap").read_bytes())


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    np.save(tmp_path / "vol.npy", np.zeros((4, 4, 4), np.uint8))
    _write_png(tmp_path / "00000.jpg", _img2(1, 8))
    # the mesh routes are ported; on the CPU the CLI sees one device
    (tmp_path / "in.txt").write_text("RunBatch: 1\nNumImages: 1\n"
                                     "Devices: 2\n")
    assert cli.main(["in.txt"], device="cpu") == 1
    assert "2 requested, 1 visible" in capsys.readouterr().out
    # the 3D dmg (solvers/dmg3d.py), Compact: 1 (solvers/compact.py) and
    # Pallas: off/interpret, refused before they were ported, now run and
    # write their rows
    for text, out in (("InputName: vol.npy\nSolver: dmg\nDtype: float64\n",
                       "dmg3d.csv"),
                      ("RunBatch: 1\nNumImages: 1\nSolver: mgcg\n"
                       "Compact: 1\n", "compact.csv"),
                      ("RunBatch: 1\nNumImages: 1\nSolver: mgcg\n"
                       "Pallas: off\n", "off.csv"),
                      ("RunBatch: 1\nNumImages: 1\nSolver: mgcg\n"
                       "Pallas: interpret\n", "interpret.csv")):
        (tmp_path / "in.txt").write_text(text + f"OutputName: {out}\n")
        assert cli.main(["in.txt"], device="cpu") == 0
        rows = (tmp_path / out).read_text().strip().splitlines()
        assert len(rows) >= 1 and np.isfinite(float(rows[-1].split(",")[3]))


def test_pipelines_need_cuda_unless_told_cpu(tmp_path, monkeypatch, capsys):
    """The entry points run on the card by default; without one they raise
    (or, for the CLI, report and exit 1) instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.SimulationConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        single.single_sim(cfg, img=_img2(1, 8), write_output=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.batch_sim(cfg, imgs=[_img2(1, 8)])
    (tmp_path / "in.txt").write_text("Phases: 2\n")
    assert cli.main([str(tmp_path / "in.txt")]) == 1
    assert "device='cpu'" in capsys.readouterr().out


@pytest.mark.parametrize("solver", ["jacobi", "jacobi_pallas"])
def test_parallel_slab_analytic(solver):
    eps, ds = 0.5, 0.1
    cfg = config.SimulationConfig(
        n_phase=2, d_fluid=1.0, d_solid=ds, convergence=1e-10,
        max_iter=100_000, check_every=200, dtype="float64",
        criterion="residual", solver=solver)
    res = single.single_sim(cfg, img=images.parallel_slab(24, eps),
                            write_output=False, device="cpu")
    np.testing.assert_allclose(res.deff, eps * 1.0 + (1 - eps) * ds,
                               rtol=1e-8)


@pytest.mark.parametrize("solver", ["jacobi", "jacobi_pallas"])
def test_three_phase_parallel_slab_analytic(solver):
    """tests/test_pipeline.py's homotopy case: only the final stage is
    recorded, Deff = LVF*Df + GVF*Dg (normalised by Df)."""
    img = images.three_phase_parallel_slab(24, svf=0.25, lvf=0.5)
    cfg = config.SimulationConfig(
        n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=200.0,
        convergence=1e-8, max_iter=1_000_000, check_every=500,
        dtype="float64", criterion="residual", solver=solver)
    res = single.single_sim_3phase(cfg, img=img, write_output=False,
                                   device="cpu")
    np.testing.assert_allclose(res.deff, 0.5 * 1.0 + 0.25 * 200.0, rtol=1e-5)
    assert res.svf == pytest.approx(0.25)
    assert res.lvf == pytest.approx(0.5)


@pytest.mark.parametrize("pallas", ["auto", "force", "off", "interpret"])
@pytest.mark.parametrize("solver", ["mgcg", "jacobi"])
def test_pallas_key_maps_as_jax(solver, pallas):
    """``Pallas: force`` pins mgcg to the "cgstep" engine, ``off`` to the
    plain cycle (``False``), ``interpret`` to "cgstep" on the kernels'
    plain versions, and ``auto`` leaves the choice to the solver, as the
    JAX batch pipeline maps them; other solvers get no engine argument."""
    jcfg = jconfig.SimulationConfig(solver=solver, pallas=pallas)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    got = batch._solver_kwargs(cfg, 1e-6, 100)
    want = jbatch._pallas_kwargs(jcfg)
    for key in ("use_pallas", "first_window"):
        assert got.get(key) == want.get(key)
