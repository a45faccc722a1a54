"""The harness on the CPU at tiny sizes: the generator, the sample, the rate
arithmetic, the output check against sound runs, planted faults and the
control, and one test for the card."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import control, gen, harness
from portbench.sample import Reservoir

TINY = {"mgcg512-b512": dict(batch=4, size=32, pool_batches=2),
        "jacobi128-b256": dict(images_per_call=4, size=32, pool_calls=2)}


def tiny_plan(cell):
    plan = harness.cell_plan(harness.benchmark(), cell)
    plan.traffic.update(TINY[cell])
    return plan


def test_generator_repeats_from_a_seed():
    seed = 2**31 + 977
    a = gen.solid_masks(gen.generator(seed, "cpu"), 3, 40, sigma=4.0,
                        porosity=0.65)
    b = gen.solid_masks(gen.generator(seed, "cpu"), 3, 40, sigma=4.0,
                        porosity=0.65)
    c = gen.solid_masks(gen.generator(seed + 1, "cpu"), 3, 40, sigma=4.0,
                        porosity=0.65)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # every image has the same porosity, whatever the seed
    assert a.sum(dim=(1, 2)).tolist() == [round(0.35 * 1600)] * 3
    assert gen.pixels(a).dtype == torch.uint8


def test_requests_take_the_pool_round_robin():
    assert [gen.round_robin(k, 3) for k in range(7)] == [0, 1, 2, 0, 1, 2, 0]


def test_reservoir_is_uniform_and_keeps_the_longest():
    hits = np.zeros(40)
    for s in range(400):
        r = Reservoir(4, np.random.default_rng(s))
        for k in range(10):
            r.offer(4, lambda i, k=k: 4 * k + i, iters=np.arange(4) + k)
        for v in r.items()[:-1]:
            hits[v] += 1
        assert r.items()[-1] == 39 and len(r.items()) == 5
    assert hits.min() > 0.5 * hits.mean() and hits.max() < 1.5 * hits.mean()


def test_rates_count_whole_requests_over_the_window():
    reqs = [dict(solves=8, t0=0.0, t1=0.5), dict(solves=8, t0=0.5, t1=1.0),
            dict(solves=8, t0=1.0, t1=2.5)]
    run = SimpleNamespace(requests=reqs, window_s=2.5)
    assert harness.load_metric("solves_per_s").read(run) == 24 / 2.5
    p95 = harness.load_metric("request_ms_p95").read(run)
    assert p95 == pytest.approx(np.percentile([500, 500, 1500], 95))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_sound_run_is_correct(cell):
    out = harness.run_cell(tiny_plan(cell), 2**31 + 5, 0.3, False, "cpu",
                           0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


def _unchanged_k1(levels, x, r, p, rz, active, stop, hi, k, **mg):
    bsz = x.shape[0]
    return (x, r, p, rz, torch.full((bsz,), k, dtype=torch.int32),
            r.abs().sum(dim=(-2, -1)).double())


def _half_k1(real):
    def k1(levels, x, r, p, rz, active, stop, hi, k, **mg):
        keep = [t.clone() for t in (x, r, p, rz)]
        out = list(real(levels, x, r, p, rz, active, stop, hi, k, **mg))
        h = x.shape[0] // 2
        for n in range(4):
            out[n][h:] = keep[n][h:]
        return tuple(out)
    return k1


def _half_k3(real):
    def k3(coeffs, x, k, omega, active=None):
        out = real(coeffs, x, k, omega=omega, active=active)
        h = x.shape[0] // 2
        return torch.cat([out[:h], x[h:]])
    return k3


def _faults(cell):
    from effectivediffusivityfvm_tpu_torch.solvers import (driver,
                                                           jacobi_pallas,
                                                           multigrid)
    if cell.startswith("mgcg"):
        real, deff = multigrid.cg_steps, multigrid.boundary_deff
        return {
            "state unchanged": (multigrid, "cg_steps", _unchanged_k1),
            "half the batch left out": (multigrid, "cg_steps",
                                        _half_k1(real)),
            "answer altered": (multigrid, "boundary_deff",
                               lambda s, x: deff(s, x) * 1.001)}
    real, deff = jacobi_pallas.jacobi_sweeps, driver.boundary_deff
    return {
        "state unchanged": (jacobi_pallas, "jacobi_sweeps",
                            lambda c, x, k, omega, active=None: x),
        "half the batch left out": (jacobi_pallas, "jacobi_sweeps",
                                    _half_k3(real)),
        "answer altered": (driver, "boundary_deff",
                           lambda s, x: deff(s, x) * 1.001)}


@pytest.mark.parametrize("fault", ["state unchanged",
                                   "half the batch left out",
                                   "answer altered"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    plan = tiny_plan(cell)
    plan.config["solver"]["max_iter"] = min(plan.config["solver"]["max_iter"],
                                            200 if cell.startswith("mgcg")
                                            else 40_001)
    mod, name, fn = _faults(cell)[fault]
    monkeypatch.setattr(mod, name, fn)
    out = harness.run_cell(plan, 2**31 + 9, 0.1, False, "cpu", 0.0)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(cell):
    checks = control.control_checks(tiny_plan(cell), 2**31 + 21, "cpu", 3)
    assert not all(v <= lim for _, v, lim in checks), checks


def test_a_qualified_metric_name_reads_with_its_base():
    assert harness.metric_file("solves_per_s.pipeline") == \
        harness.metric_file("solves_per_s")
    assert harness.metric_file("device.idle_share.small_batch").name == \
        "device.idle_share.py"
    assert harness.metric_file("device.idle_share").name == \
        "device.idle_share.py"
    with pytest.raises(FileNotFoundError):
        harness.metric_file("no_such.metric")


def test_the_control_takes_the_precision_below():
    assert control.lower_dtype({"dtype": "float64"}) == "float32"
    assert control.lower_dtype({"dtype": "float32"}) == "bfloat16"
    with pytest.raises(ValueError, match="int8"):
        control.lower_dtype({"dtype": "int8"})


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_float32_configuration_takes_the_reference_in_bfloat16(
        cell, monkeypatch):
    from effectivediffusivityfvm_tpu_torch.pipeline import batch
    from effectivediffusivityfvm_tpu_torch.solvers import multigrid

    def refused(*a, **kw):
        raise AssertionError("the program has no bfloat16 path to run")

    monkeypatch.setattr(multigrid, "solve_mgcg_batched", refused)
    monkeypatch.setattr(batch, "batch_sim", refused)
    plan = tiny_plan(cell)
    plan.config["dtype"] = "float32"
    checks = control.control_checks(plan, 2**31 + 23, "cpu", 3)
    assert not all(v <= lim for _, v, lim in checks), checks


def test_batch_sim_names_what_it_cannot_judge_or_read():
    from portbench.entries import batch_sim

    plan = tiny_plan("jacobi128-b256")
    sol = plan.config["solver"]
    sol["name"] = "mgcg"
    del sol["omega"]
    entry = batch_sim.Entry(plan.config, plan.traffic, 7, "cpu")
    try:
        assert entry.work()["kind"] is None
        with pytest.raises(NotImplementedError, match="'mgcg'"):
            entry.check()
        with pytest.raises(NotImplementedError, match="'mgcg'"):
            entry.control([(0, 0)])
        with pytest.raises(RuntimeError, match="solve_image_group"):
            entry.after(0, (0, np.zeros((4, 9))))
    finally:
        entry.release()


@pytest.mark.gpu
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = harness.run_cell(tiny_plan("mgcg512-b512"), 11, 0.5, True, "cuda",
                           0.0)
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert "k1.roofline_share" in out["metrics"]
