"""K6's resident rule (``ops/kernels/vcycle3d.py::cycle3_resident_from`` and
``cycle3_launches``, the Python twin of ``csrc/vcycle3d.cuh``): the levels
the rule puts in one CTA fit its shared memory, the level above them does
not, the rule reads only the level shapes and the element size, and config
5's cycle on ``levels[1:]`` takes 7 launches in float32 and 9 in float64.
A card test (``tests/test_torch_gpu.py``) holds the Python rule equal to
the C one.  Shapes and arithmetic only, plus two small CPU hierarchies: no
JAX.
"""

import numpy as np
import pytest
import torch

from effectivediffusivityfvm_tpu_torch.ops import fvm3d
from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle3d import (
    RESIDENT3_LEVELS, RESIDENT3_SMEM, band_z_for, cycle3_launches,
    cycle3_resident_from, pad_shape_3d)
from effectivediffusivityfvm_tpu_torch.solvers import solvers3d


def _hierarchy(shape, itemsize, min_size=4):
    """The banded engine's level shapes of an unpadded volume, as
    ``solvers3d.tiled3d_system`` builds them: level 0 padded to the band and
    to even dims, then halved and padded to even until a dim is at most
    ``min_size``."""
    nz, ny, nx = shape
    level = pad_shape_3d(nz, ny, nx, band_z_for(nz, ny + ny % 2, nx + nx % 2,
                                                itemsize))
    shapes = [level]
    while min(level) > min_size:
        level = tuple(v // 2 + (v // 2) % 2 for v in level)
        shapes.append(level)
    return shapes


def _cells(s):
    return s[0] * s[1] * s[2]


# config 5's volume, the card tests' shapes, and a pyramid whose coarsest
# level is odd (the rule takes any coarsest level)
CASES = {
    "256^3": _hierarchy((256, 256, 256), 4),
    "40x36x52": _hierarchy((40, 36, 52), 4),
    "37x20x40": _hierarchy((37, 20, 40), 4),
    "odd coarsest": [(48, 40, 64), (24, 20, 32), (12, 10, 16), (5, 5, 7)],
}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_cycle3_resident_levels_fit_one_cta(name, itemsize):
    for shapes in (CASES[name], CASES[name][1:]):
        lb = cycle3_resident_from(shapes, itemsize)
        n = len(shapes)
        assert 0 <= lb <= n
        if lb < n:
            cells = (6 * sum(_cells(s) for s in shapes[lb:])
                     + _cells(shapes[lb]))
            assert cells * itemsize <= RESIDENT3_SMEM
            assert n - lb <= RESIDENT3_LEVELS
        if lb > 0:                   # the level above the bottom does not fit
            up = 6 * sum(_cells(s) for s in shapes[lb - 1:]) \
                + _cells(shapes[lb - 1])
            assert up * itemsize > RESIDENT3_SMEM
        assert cycle3_launches(shapes, itemsize) == 2 * min(lb, n - 1) + 1


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_cycle3_rule_reads_shapes_and_itemsize_alone(name, itemsize):
    shapes = CASES[name]
    lb = cycle3_resident_from(shapes, itemsize)
    as_lists = [list(s) for s in shapes]
    as_numpy = [tuple(np.int64(v) for v in s) for s in shapes]
    assert cycle3_resident_from(as_lists, itemsize) == lb
    assert cycle3_resident_from(as_numpy, itemsize) == lb
    # a larger element can only move the bottom down the pyramid
    assert cycle3_resident_from(shapes, 8) >= cycle3_resident_from(shapes, 4)


@pytest.mark.parametrize("shape", [(40, 36, 52), (37, 20, 40), (13, 9, 22)])
def test_cycle3_rule_on_the_hierarchy_the_engine_builds(shape):
    """The level shapes above are those of ``tiled3d_system``'s hierarchy,
    so the rule the tests reckon is the one the kernel applies."""
    rng = np.random.default_rng(0)
    d = torch.tensor(np.exp(rng.uniform(0, np.log(1e4), (1,) + shape)),
                     dtype=torch.float32)
    levels, _ = solvers3d.tiled3d_system(
        fvm3d.fvm_coefficients_3d(d, 0.0, 1.0), min_size=4)
    assert [tuple(c.diag.shape[-3:]) for c in levels] == _hierarchy(shape, 4)


@pytest.mark.parametrize("itemsize,resident_from,launches", [
    (4, 3, 7),          # 128^3, 64^3, 32^3 in passes; 16^3 down in one CTA
    (8, 4, 9),          # 16^3 in passes too; 8^3 down in one CTA
])
def test_cycle3_config5_tail(itemsize, resident_from, launches):
    """Config 5 (B=1 x 256^3): the whole cycle on levels[1:] as K7 and the
    banded cycle run it."""
    tail = CASES["256^3"][1:]
    assert tail[0] == (128, 128, 128) and tail[-1] == (4, 4, 4)
    assert cycle3_resident_from(tail, itemsize) == resident_from
    assert cycle3_launches(tail, itemsize) == launches
