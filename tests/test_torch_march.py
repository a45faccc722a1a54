"""The z-marching rule (``ops/kernels/cgstep3d.py::march3_plan``, the
Python twin of ``csrc/march3d.cuh``): every shape the 3D tests and the
smoke give K7 and K6's level passes fits the H100's shared memory in every
pass, float32 and float64, nu = 1..3; the z-segments of both cover each
volume exactly in even lengths; and config 5's volume (B=1 x 256^3) gives
one wave of two CTAs an SM on the card's 132 SMs.  A card test
(``tests/test_torch_gpu.py``) holds the Python rule equal to the C one.
Shapes and arithmetic only: no JAX, no tensors.
"""

import pytest

from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep3d import (
    SMEM_BLOCK_MAX, SMEM_SM, march3_plan)
from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle3d import (
    band_z_for, pad_shape_3d)

SMS = 132                # the H100's SMs
STATIC_SMEM = 256 * 8    # the passes' block-sum array (one double a thread)
RESERVED_SMEM = 1024     # the card reserves 1 KiB of shared memory a block


def _level0(shape, itemsize):
    """The banded engine's padded level-0 shape of an unpadded volume."""
    return pad_shape_3d(*shape, band_z_for(*shape, itemsize))


# tests/test_torch_gpu.py's SHAPES_3D and its segment-crossing shape, phase
# 19's 100x64x90 and config 5's 256^3
SHAPES = [(16, 10, 12), (13, 9, 22), (40, 36, 52), (37, 20, 40),
          (100, 64, 90), (256, 256, 256)]


@pytest.mark.parametrize("nu", [1, 2, 3])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_march3_plan_fits_and_covers(shape, itemsize, nu):
    nz, ny, nx = level0 = _level0(shape, itemsize)
    plan = march3_plan(level0, itemsize, nu)
    for key, nbytes in plan["smem"].items():
        assert nbytes + STATIC_SMEM <= SMEM_BLOCK_MAX, (key, nbytes)
    seg = plan["seg_len"]
    assert seg % 2 == 0 and seg >= 2
    assert (plan["segments"] - 1) * seg < nz <= plan["segments"] * seg
    assert seg >= min(nz, max(8, 4 * nu))
    ty, tx = plan["tile"]
    assert plan["tiles"] == -(-ny // ty) * -(-nx // tx)
    assert plan["ctas"] == plan["tiles"] * plan["segments"]
    # K6's level passes: even segments down to 2 slices, one wave at most
    # where the volume has the slices for it
    lseg = plan["level_seg_len"]
    assert lseg % 2 == 0 and 2 <= lseg <= seg
    assert (plan["level_segments"] - 1) * lseg < nz <= \
        plan["level_segments"] * lseg
    assert plan["level_ctas"] == plan["tiles"] * plan["level_segments"]
    assert plan["level_ctas"] <= max(plan["tiles"], 2 * SMS) or lseg == 2


@pytest.mark.parametrize("nu", [1, 2])
def test_march3_plan_fills_the_card_at_b1(nu):
    """Config 5 (nu = 2) at B=1: each pass's shared memory lets two CTAs
    run on an SM at once, and the volume gives one wave of them: at least
    two CTAs for each of 128 SMs, at most two for each of the 132."""
    plan = march3_plan((256, 256, 256), 4, nu)
    assert 2 * 128 <= plan["ctas"] <= 2 * SMS
    for key, nbytes in plan["smem"].items():
        per_sm = SMEM_SM // (nbytes + STATIC_SMEM + RESERVED_SMEM)
        assert per_sm >= 2, (key, nbytes)


def test_march3_plan_is_a_function_of_shape_itemsize_and_nu():
    a = march3_plan((256, 256, 256), 4, 2)
    assert a == march3_plan([256, 256, 256], 4, 2)
    assert a["tile"] == (16, 32) and march3_plan((256,) * 3, 8, 2)["tile"] \
        == (8, 32)
    # nu = 3's longer chains keep longer segments
    assert march3_plan((40, 36, 52), 4, 3)["seg_len"] >= 12
