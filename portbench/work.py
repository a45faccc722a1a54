"""The yardstick of the roofline shares: the card's peaks and the work each
kernel's call needs, frozen here from ``chip_smoke.py`` (``bound``,
``cycle_work``, K1's and K3's counts in its phases 6 and 11).

Each input byte is counted read once and each output byte written once per
call, whatever a kernel reads again; the operations are what these inputs
need (live iterations and sweeps, not launched ones).  A later kernel that
does the same work reads against the same counts, whatever implements it.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at the full 700 W: HBM3 bytes/s and
# the float32 and float64 rates outside the tensor cores.
HBM_BPS = 3.35e12
PEAK_OPS = {4: 67e12, 8: 34e12}                 # by element size


def bound_s(nbytes: float, ops: float, itemsize: int) -> float:
    """Least seconds for ``nbytes`` moved and ``ops`` operations."""
    return max(nbytes / HBM_BPS, ops / PEAK_OPS[itemsize])


def hierarchy_cells(ny: int, nx: int, min_size: int) -> list:
    """Cells of each level of the MGCG hierarchy, level 0 first: every
    level padded to even sides, each coarser level half of the one above,
    down to the first level whose smaller side is at most ``min_size``."""
    cells = []
    while True:
        ny, nx = ny + ny % 2, nx + nx % 2
        cells.append(ny * nx)
        if min(ny, nx) <= min_size:
            return cells
        ny, nx = ny // 2, nx // 2


def cycle_work(cells: list, images: int, itemsize: int, nu: int):
    """``(bytes, operations)`` of one V(nu, nu) cycle on ``images`` images:
    reads a_w, a_n and diag_inv of every level and r, writes z; per cell of
    a level 5 + 24 nu operations."""
    nbytes = itemsize * images * (3 * sum(cells) + 2 * cells[0])
    ops = images * (5 + 24 * nu) * sum(cells)
    return nbytes, ops


def k1_call_work(cells: list, itemsize: int, nu: int, live: int):
    """``(bytes, operations)`` of one image in one K1 call that runs
    ``live`` PCG iterations for it: the hierarchy, b, x, r and p read and x,
    r and p written once; ``live + 1`` cycles (the refresh's included), 22
    operations a cell an iteration for the CG updates, dot products and
    matrix-vector products, and 15 in the refresh."""
    nbytes = itemsize * (3 * sum(cells) + 7 * cells[0])
    ops = (live + 1) * (5 + 24 * nu) * sum(cells) + cells[0] * (22 * live
                                                                + 15)
    return nbytes, ops


def k1_calls(iters: int, first: int, window: int) -> int:
    """K1 calls in which an image that ran ``iters`` live iterations was
    active: a first window of ``first`` iterations, then windows of
    ``window``."""
    return 1 + math.ceil(max(0, iters - first) / window)


def k3_call_work(cells: int, itemsize: int, sweeps: int):
    """``(bytes, operations)`` of one image in one K3 call of ``sweeps``
    sweeps: a_w, a_n, diag_inv, b and x read and the result written once;
    12 operations a cell a sweep."""
    return 6 * itemsize * cells, 12 * cells * sweeps


def jacobi_windows(sweeps: int, check_every: int) -> int:
    """K3 calls of an image that ran ``sweeps`` sweeps: the first sweep
    alone, then one call a check window."""
    return 1 + math.ceil(max(0, sweeps - 1) / check_every)
