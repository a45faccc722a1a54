"""The frozen work counts against hand counts on tiny shapes, and the
reduction of a trace to kernel times."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, trace, work
from portbench.trace import Event, Trace


def test_hierarchy_of_an_odd_grid():
    # 30x18 -> pad 30x18 (already even) -> 15x9 -> pad 16x10 -> 8x5
    # -> pad 8x6: its smaller side 6 <= 8 stops
    assert work.hierarchy_cells(30, 18, 8) == [540, 160, 48]
    assert work.hierarchy_cells(512, 512, 8) == [
        512 ** 2, 256 ** 2, 128 ** 2, 64 ** 2, 32 ** 2, 16 ** 2, 8 ** 2]


def test_cycle_and_k1_counts_by_hand():
    cells = [16, 4]                     # a 4x4 grid and its 2x2 level
    # V(1,1): 5 + 24 = 29 operations a cell a level; 3 coefficient planes
    # a level, r in and z out at level 0
    assert work.cycle_work(cells, 2, 4, 1) == (4 * 2 * (3 * 20 + 2 * 16),
                                               2 * 29 * 20)
    nbytes, ops = work.k1_call_work(cells, 4, 1, live=3)
    assert nbytes == 4 * (3 * 20 + 7 * 16)
    assert ops == 4 * 29 * 20 + 16 * (22 * 3 + 15)


def test_calls_of_a_window():
    assert work.k1_calls(0, 40, 40) == 1
    assert work.k1_calls(40, 40, 40) == 1
    assert work.k1_calls(41, 40, 40) == 2
    assert work.k1_calls(100, 1, 40) == 4          # 1 + 40 + 40 + 19
    # the reference protocol: the first sweep alone, then windows of 10000;
    # MaxIter 5e5 gives K3's 51 launches
    assert work.jacobi_windows(1, 10_000) == 1
    assert work.jacobi_windows(20_001, 10_000) == 3
    assert work.jacobi_windows(500_000, 10_000) == 51
    assert work.k3_call_work(16, 4, 10) == (6 * 4 * 16, 12 * 16 * 10)
    assert work.k3_call_work(16, 8, 10) == (6 * 8 * 16, 12 * 16 * 10)


def test_k3_share_of_a_float64_cell_by_hand():
    # two images of 16 cells, 3 and 10,001 sweeps: two K3 calls each (the
    # first sweep, then one window of 10,000); 1 us of K3 in the trace
    run = SimpleNamespace(
        work=dict(kind="jacobi", itemsize=8, cells=16, check_every=10_000),
        trace=_trace([(0, 1000, "void deff::jacobi_resident<double>(...)")]),
        requests=[dict(iters=np.array([3, 10_001]))])
    nbytes, ops = 6 * 8 * 16 * 4, 12 * 16 * (3 + 10_001)
    want = 100.0 * max(nbytes / 3.35e12, ops / 34e12) / 1e-6
    got = harness.load_metric("k3.roofline_share").read(run)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("dtype,itemsize", [("float64", 8), ("float32", 4)])
def test_the_jacobi_entry_counts_in_its_configuration_dtype(dtype, itemsize):
    from portbench.entries import batch_sim

    plan = harness.cell_plan(harness.benchmark(), "jacobi128-b256")
    plan.config["dtype"] = dtype
    plan.traffic.update(images_per_call=2, size=32, pool_calls=1)
    entry = batch_sim.Entry(plan.config, plan.traffic, 5, "cpu")
    try:
        w = entry.work()
    finally:
        entry.release()
    assert w["kind"] == "jacobi" and w["itemsize"] == itemsize
    assert w["cells"] == 1024 and w["check_every"] == 10_000


def test_bound_takes_the_larger_time():
    assert work.bound_s(3.35e12, 0, 4) == 1.0
    assert work.bound_s(0, 67e12, 4) == 1.0
    assert work.bound_s(0, 34e12, 8) == 1.0


def _trace(events):
    dev = [Event(s, e, n) for s, e, n in events]
    return Trace(dev, [], [], Event(0, 1000, "pb:window"))


def test_k1_owns_its_call_and_k2_the_rest():
    tr = _trace([
        (0, 10, "void deff::level_down_kernel<float, 2, K2Level>(...)"),
        (12, 20, "void deff::bottom_kernel<float>(...)"),
        (30, 35, "Memset (Device)"),
        (35, 40, "void deff::set_act_kernel<float>(...)"),
        (40, 60, "void deff::pass_x_kernel<float, 2, true>(...)"),
        (60, 70, "void deff::level_down_kernel<float, 2, K2Level>(...)"),
        (70, 75, "void deff::fin_refresh_kernel<float>(...)"),
        (80, 90, "void at::native::elementwise_kernel<...>(...)"),
    ])
    assert trace.split_k1_k2(tr) == (45, 18)


def test_busy_union_and_intervals():
    tr = _trace([(0, 10, "a"), (5, 20, "b"), (30, 40, "c"), (990, 2000,
                                                                "d")])
    busy = trace.Busy(tr)
    assert busy.total() == 20 + 10 + 10
    assert busy.within(0, 1000) == 40
    assert busy.within(15, 35) == 5 + 5
    assert busy.within(21, 29) == 0
    assert trace.short("void deff::pass_p_kernel<float, 1>(int)") == \
        "pass_p_kernel"
