"""Connectivity analysis: percolation screening and non-participating pores
(torch port of ``effectivediffusivityfvm_tpu.models.floodfill``).

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

:func:`flood_fill` runs on the host: the C++ union-find library
(:mod:`._native`, the default) or the scipy route, which give the same
masks.  :func:`participating_mask_device` is the same classification as
iterative label propagation in torch ops, on the caller's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["FloodFillResult", "flood_fill", "participating_mask_device"]


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
      use_native: try the C++ union-find library first
        (``csrc/preprocess.cpp``, built on first use; see
        :mod:`._native`) -- same semantics, linear time, GIL-free.  Takes
        the scipy route when the library cannot be built.
    """
    if use_native:
        from . import _native

        out = _native.flood_fill_native(np.asarray(solid, bool))
        if out is not None:
            return FloodFillResult(*out)
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


_SPREADS_A_CHECK = 32    # spreads between two fixpoint tests (host reads)


def participating_mask_device(solid, max_steps: Optional[int] = None):
    """:func:`flood_fill`'s classification as iterative label propagation
    in torch ops on the device of ``solid`` (a bool tensor ``(..., ny,
    nx)``, or an array, taken to the CPU): ``(participating, isolated,
    path_flag)`` as tensors there.

    Each fluid cell carries a 2-bit mask, bit 0 "reached from the left
    column" and bit 1 "from the right one", seeded on those columns and
    spread through 4-connected fluid neighbours, periodic in Y, until a
    fixpoint (at most ``max_steps`` spreads after the first, default ``ny *
    nx``, the worst serpentine path).  The fixpoint is tested every 32
    spreads, one host read each: past it a spread changes nothing, so the
    masks are the JAX package's ``while_loop``'s."""
    solid = torch.as_tensor(solid).bool()
    ny, nx = solid.shape[-2:]
    fluid = ~solid
    if max_steps is None:
        max_steps = ny * nx
    zero = torch.zeros((), dtype=torch.uint8, device=solid.device)

    init = torch.zeros(solid.shape, dtype=torch.uint8, device=solid.device)
    init[..., :, 0] = fluid[..., :, 0].to(torch.uint8)
    init[..., :, -1] += 2 * fluid[..., :, -1].to(torch.uint8)

    def spread(m):
        w = torch.nn.functional.pad(m[..., :, :-1], (1, 0))
        e = torch.nn.functional.pad(m[..., :, 1:], (0, 1))
        n = torch.roll(m, 1, dims=-2)       # periodic in Y (Deff2D.cuh:640)
        s = torch.roll(m, -1, dims=-2)
        return torch.where(fluid, m | w | e | n | s, zero)

    m = spread(init)
    done = 0
    while done < max_steps:
        for _ in range(min(_SPREADS_A_CHECK, max_steps - done)):
            prev, m = m, spread(m)
            done += 1
        if torch.equal(m, prev):
            break
    participating = (m > 0) & fluid
    return participating, fluid & ~participating, torch.any(m == 3)
