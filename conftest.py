"""Per-test time limit for every pytest run in this repository.

It sits above ``tests/`` so that it covers each test file while
``tests/conftest.py``, the JAX reference package's own harness, stays as
it is. It imports nothing but pytest and the standard library, so
``tests/test_harness.py`` can load it alone into a sub-session.

A SIGALRM timer (``signal.setitimer``) runs over each test's call phase;
when it fires, the test fails with "time limit N s" and its node id in
the report. xdist workers run tests on their main thread, so the timer
works under ``-n`` too. The limit is ``DEFAULT_LIMIT_S`` unless the test
carries ``@pytest.mark.timelimit(seconds)``, or is named in
``LONG_TESTS``, which gives the reference package's long tests their
limits without a mark in their files.

A signal handler only runs between Python bytecodes, so a test stuck
inside one C call (an XLA compile, a blocked read) fails only when that
call returns. For that case ``faulthandler`` writes every thread's stack
to the process's stderr when the limit passes, so the log shows where it
hangs. It does not kill the worker: under ``--dist loadfile``,
pytest-xdist (3.8) hands a crashed worker's whole file, the crashed test
included, to the next worker, which then hangs in the same place.
"""

import faulthandler
import os
import signal
import sys
import threading

import pytest

DEFAULT_LIMIT_S = 300.0

# The tests that take over 100 s each run alone (8-core x86 CPU, JAX on
# eight virtual CPU devices, the XLA compile of a whole solver most of
# it), each with three times its longest time: under six xdist workers
# they can run past the default. Node ids without their parameters.
LONG_TESTS = {
    "tests/test_volume.py::TestDmg3D::test_dmg3d_batched_matches_solo": 1250,
    "tests/test_volume.py::TestDmg3D::test_dmg3d_matches_mgcg_deff": 800,
    "tests/test_sharding.py::TestSharded3D::test_sharded_mgcg_batched_dp_sp": 680,
    "tests/test_volume.py::TestVolumePipeline::test_three_phase_parallel": 680,
    "tests/test_sharding.py::TestSharded3D::test_sharded_mgcg_equals_unsharded": 660,
    "tests/test_volume.py::TestVolumeBatch::test_batch_3phase_cmap3d": 640,
    "tests/test_volume.py::TestVolumeBatch::test_batch_2phase_matches_singles": 600,
    "tests/test_volume.py::TestDmg3D::test_volume_batch_sim_3phase_dmg": 450,
    "tests/test_kernels3d.py::test_fused3d_matrix_free_padded": 450,
    "tests/test_volume.py::TestDmg3D::test_volume_pipeline_dmg_slab_analytic": 450,
    "tests/test_sharding.py::test_batch_sim_dp_sp_mesh_mgcg": 410,
    "tests/test_kernels3d.py::test_fused3d_solver_matches_xla_engine": 410,
    "tests/test_sharding.py::test_batch_sim_3phase_dp_mesh_identical": 380,
    "tests/test_kernels3d.py::test_fused3d_single_image": 360,
    "tests/test_volume.py::TestVolumePipeline::test_parallel_slabs_2phase": 330,
    "tests/test_sharding.py::test_batch_sim_dp_mesh_identical": 330,
    "tests/test_volume.py::TestVolumePipeline::test_cli_npy_path": 330,
    "tests/test_3d.py::TestSolvers3D::test_mgcg_fewer_iterations": 320,
    "tests/test_autodiff.py::test_jit_and_grad_compose": 320,
    "tests/test_3d.py::TestSolvers3D::test_mgcg_matches_direct": 310,
    "tests/test_pallas_kernel.py::TestFusedCGStep::"
    "test_fused_chebyshev_schedule_matches_xla": 310,
}

_stderr_fd = pytest.StashKey[int]()


def pytest_configure(config):
    # a copy of the process's stderr taken now: pytest's capture swaps fd 2
    # during each test, and a dump written there would go to the test's
    # captured output, not to the log
    config.stash[_stderr_fd] = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    fd = config.stash.get(_stderr_fd, None)
    if fd is not None:
        os.close(fd)
        del config.stash[_stderr_fd]


def pytest_collection_modifyitems(items):
    for item in items:
        limit = LONG_TESTS.get(item.nodeid.split("[")[0])
        if limit and not item.get_closest_marker("timelimit"):
            item.add_marker(pytest.mark.timelimit(limit))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if threading.current_thread() is not threading.main_thread():
        return (yield)
    mark = item.get_closest_marker("timelimit")
    limit = float(mark.args[0]) if mark else DEFAULT_LIMIT_S

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid}: time limit {limit:g} s exceeded")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit, file=item.config.stash[_stderr_fd])
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
