"""3D voxel-domain preprocessing (the port's copy of
``effectivediffusivityfvm_tpu.models.volume``, numpy and scipy only): the 3D
extension of models/phases + models/floodfill; the reference is 2D-only —
this serves BASELINE.json config 5.

Conventions mirror the 2D ones: same grayscale thresholds per voxel
(2-phase: <150 fluid; 3-phase: >200 solid / <50 gas), transport along x,
flood-fill connectivity is 6-connected, non-periodic in x, periodic in y and
z (the natural extension of the reference's periodic-Y / non-periodic-X rule,
Deff2D.cuh:640-671)."""

from __future__ import annotations

import numpy as np

from .floodfill import FloodFillResult

__all__ = ["flood_fill_3d", "porosity_3d", "amplify_3d"]


def porosity_3d(vol: np.ndarray) -> float:
    """Fraction of voxels < 150 (2-phase pore convention)."""
    return float(np.count_nonzero(vol < 150)) / float(vol.size)


def amplify_3d(grid: np.ndarray, amp_z: int, amp_y: int, amp_x: int) -> np.ndarray:
    if amp_z == amp_y == amp_x == 1:
        return grid
    g = np.repeat(grid, amp_z, axis=0)
    g = np.repeat(g, amp_y, axis=1)
    return np.repeat(g, amp_x, axis=2)


def flood_fill_3d(solid: np.ndarray) -> FloodFillResult:
    """Connectivity of the non-solid space of a voxel volume.

    participating = 6-connected to either x-boundary face (periodic y/z);
    path_flag = some component touches both x faces (percolation);
    isolated = non-solid but unreachable (identity rows in 3-phase mode).
    """
    from scipy import ndimage

    fluid = ~np.asarray(solid, bool)
    structure = ndimage.generate_binary_structure(3, 1)  # 6-connectivity
    labels, num = ndimage.label(fluid, structure=structure)
    if num == 0:
        z = np.zeros_like(fluid)
        return FloodFillResult(z, z.copy(), False)

    parent = np.arange(num + 1)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def unite(a, b):
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[rb] = ra

    # periodic wrap in z (axis 0) and y (axis 1)
    top, bot = labels[0, :, :], labels[-1, :, :]
    both = (top > 0) & (bot > 0)
    for a, b in zip(top[both].ravel(), bot[both].ravel()):
        unite(a, b)
    front, back = labels[:, 0, :], labels[:, -1, :]
    both = (front > 0) & (back > 0)
    for a, b in zip(front[both].ravel(), back[both].ravel()):
        unite(a, b)

    roots = np.array([find(int(i)) for i in range(num + 1)])
    labels = roots[labels]

    left = np.unique(labels[:, :, 0])
    right = np.unique(labels[:, :, -1])
    left = set(left[left > 0].tolist())
    right = set(right[right > 0].tolist())
    reach = left | right
    if reach:
        participating = np.isin(labels, sorted(reach)) & fluid
    else:
        participating = np.zeros_like(fluid)
    isolated = fluid & ~participating
    return FloodFillResult(participating, isolated, len(left & right) > 0)
