"""Connectivity analysis: percolation screening and non-participating pores
(the port's copy of the scipy path of
``effectivediffusivityfvm_tpu.models.floodfill``).

Re-designs the reference's BFS ``FloodFill`` (Deff2D.cuh:557-713, a
``std::set``-frontier CPU BFS) as a label-based union-find pass:

  * 4-connected components of the non-solid space (``scipy.ndimage.label``),
  * periodic wrap in Y merged by union-find over the labels touching the top
    and bottom rows (reference: periodic north/south neighbors,
    Deff2D.cuh:640-671; non-periodic in X),
  * participating = connected to the left OR right boundary column (the
    reference seeds both boundary columns, Deff2D.cuh:593-605),
  * ``path_flag`` = some component touches BOTH boundary columns, i.e. true
    left<->right percolation.

This implements the *documented intent*.  The reference line
``if(Domain[indexR == -1])`` (Deff2D.cuh:601) is a known bug — the comparison
sits inside the index, so right-boundary seeding actually tests ``Domain[0]``
— and is deliberately not replicated.

Host preprocessing in numpy, off the device path.  The JAX package's C++
union-find bridge (``models/_native.py``) and its on-device variant
(``participating_mask_device``) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["FloodFillResult", "flood_fill"]


class FloodFillResult(NamedTuple):
    participating: np.ndarray  # bool (ny, nx): non-solid AND boundary-connected
    isolated: np.ndarray       # bool (ny, nx): non-solid but unreachable (Grid==2)
    path_flag: bool            # left<->right percolation exists


def _label_periodic_y(fluid: np.ndarray) -> np.ndarray:
    """4-connected labels of ``fluid`` with periodic wrap in Y.

    Returns an int array where 0 = solid, >0 = component id (canonical).
    """
    from scipy import ndimage

    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    labels, num = ndimage.label(fluid, structure=structure)
    if num == 0:
        return labels

    # Union-find over label ids to merge top/bottom periodic neighbors.
    parent = np.arange(num + 1)

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    top, bot = labels[0, :], labels[-1, :]
    both = (top > 0) & (bot > 0)
    for a, b in zip(top[both], bot[both]):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[rb] = ra

    roots = np.array([find(int(i)) for i in range(num + 1)])
    return roots[labels]


def flood_fill(solid: np.ndarray, use_native: bool = True) -> FloodFillResult:
    """Classify the non-solid space of a single image.

    Args:
      solid: bool (ny, nx); True = impermeable cell (2-phase: pixel > 150,
        Deff2D.cuh:1695; 3-phase: pixel > 200, Deff2D.cuh:1368).
      use_native: kept for the JAX signature.  The C++ library it selects
        there has the same semantics and is not ported yet, so every call
        takes the scipy path.
    """
    del use_native
    fluid = ~np.asarray(solid, bool)
    labels = _label_periodic_y(fluid)

    left = np.unique(labels[:, 0])
    right = np.unique(labels[:, -1])
    left = set(left[left > 0].tolist())
    right = set(right[right > 0].tolist())

    reach = left | right
    if reach:
        participating = np.isin(labels, sorted(reach)) & fluid
    else:
        participating = np.zeros_like(fluid)
    isolated = fluid & ~participating
    path_flag = len(left & right) > 0
    return FloodFillResult(participating, isolated, bool(path_flag))
