"""Phase classification and diffusivity-field construction.

Re-implements the reference's image->domain conventions (thresholds are part
of the input spec, documentation PDF §2.2):

2-phase (reference SingleSim/BatchSim):
  * porosity = fraction of *original* pixels with value < 150, counted
    pre-amplification (calcPorosity, Deff2D.cuh:383-408);
  * flood-fill solid grid: pixel > 150 (Deff2D.cuh:1695);
  * diffusivity: pixel < 150 -> D_fluid else D_solid, with integer mesh
    amplification by nearest-neighbor replication
    (``targetIndex = i / MeshAmp``, Deff2D.cuh:1777-1785).

3-phase (reference SingleSim3Phase/BatchSim3Phase; PDF: solid=255, fluid=150,
gas=0):
  * solid: pixel > 200; gas: pixel < 50; fluid otherwise
    (Deff2D.cuh:1456-1467);
  * volume fractions SVF/LVF counted on the amplified mesh
    (calcFracts3D, Deff2D.cuh:411-448);
  * solid cells and flood-fill-isolated pores become identity rows via the
    phase mask.

Note (documented reference quirk, not replicated): the reference builds its
flood-fill grid indexing by the original image width while looping amplified
mesh dims (Deff2D.cuh:1693-1701), which is only correct for MeshAmp == 1.
Here classification always happens on the original pixel grid and is then
replicated, which is exactly equivalent for connectivity and correct for all
amplification factors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "porosity",
    "two_phase_classes",
    "three_phase_classes",
    "amplify",
    "d_field_from_classes",
    "phase_fractions",
    "SOLID",
    "FLUID",
    "GAS",
]

# Phase class codes (per-pixel uint8 grid).
FLUID = 0
SOLID = 1
GAS = 2


def porosity(img: np.ndarray) -> float:
    """2-phase porosity: fraction of original pixels < 150 (Deff2D.cuh:401)."""
    return float(np.count_nonzero(img < 150)) / float(img.size)


def two_phase_classes(img: np.ndarray) -> np.ndarray:
    """Pixel < 150 -> fluid, else solid (Deff2D.cuh:1779-1783).

    (The flood-fill grid in the reference uses > 150 for solid — pixels equal
    to exactly 150 are 'solid' for diffusivity and 'not solid' for the fill;
    we follow the diffusivity convention for both, the fill convention is
    handled by the caller passing ``solid = classes == SOLID``.)
    """
    return np.where(img < 150, FLUID, SOLID).astype(np.uint8)


def three_phase_classes(img: np.ndarray) -> np.ndarray:
    """Pixel > 200 -> solid, < 50 -> gas, else fluid (Deff2D.cuh:1456-1467)."""
    out = np.full(img.shape, FLUID, dtype=np.uint8)
    out[img > 200] = SOLID
    out[img < 50] = GAS
    return out


def amplify(grid: np.ndarray, amp_y: int, amp_x: int) -> np.ndarray:
    """Integer mesh amplification by nearest-neighbor replication.

    Equivalent to the reference's ``targetIndexRow = i / MeshAmpY`` downsample
    indexing (Deff2D.cuh:1777-1785) viewed from the other direction.
    """
    if amp_y == 1 and amp_x == 1:
        return grid
    return np.repeat(np.repeat(grid, amp_y, axis=0), amp_x, axis=1)


def d_field_from_classes(
    classes: np.ndarray,
    d_fluid: float,
    d_solid: float,
    d_gas: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """Per-cell diffusivity from the (already amplified) class grid."""
    lut = np.asarray([d_fluid, d_solid, d_gas], dtype=dtype)
    return lut[classes]


def phase_fractions(classes: np.ndarray) -> Tuple[float, float]:
    """(SVF, LVF) on the amplified mesh (calcFracts3D, Deff2D.cuh:411-448)."""
    n = float(classes.size)
    svf = float(np.count_nonzero(classes == SOLID)) / n
    lvf = float(np.count_nonzero(classes == FLUID)) / n
    return svf, lvf
