"""Carry the JAX package's solver state into the port.

Each array function takes the JAX-side structure with its arrays as numpy
arrays (or anything ``np.asarray`` accepts, such as JAX arrays) and returns
the port's structure of torch tensors on ``device`` in ``dtype``.  Fields
are read by name, so any NamedTuple with the same field names will do.
:func:`config_from_fields` carries a run's configuration.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .config import SimulationConfig
from .ops.flux import BoundaryFluxSpec
from .ops.fvm import StencilCoeffs
from .ops.fvm3d import FluxSpec3D, StencilCoeffs3D

__all__ = ["coeffs_from_numpy", "spec_from_numpy", "levels_from_numpy",
           "coeffs3d_from_numpy", "spec3d_from_numpy", "levels3d_from_numpy",
           "config_from_fields"]


def config_from_fields(d: dict) -> SimulationConfig:
    """The JAX package's configuration, as ``dataclasses.asdict`` gives it,
    → a validated :class:`SimulationConfig` with the same fields."""
    cfg = SimulationConfig(**d)
    cfg.validate()
    return cfg


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def coeffs_from_numpy(c, device, dtype) -> StencilCoeffs:
    """A ``StencilCoeffs``-like structure → :class:`StencilCoeffs`."""
    return StencilCoeffs(*(_tensor(getattr(c, f), device, dtype)
                           for f in StencilCoeffs._fields))


def spec_from_numpy(s, device, dtype) -> BoundaryFluxSpec:
    """A ``BoundaryFluxSpec``-like structure → :class:`BoundaryFluxSpec`."""
    return BoundaryFluxSpec(*(_tensor(getattr(s, f), device, dtype)
                              for f in BoundaryFluxSpec._fields))


def levels_from_numpy(levels: Sequence, device, dtype) -> List[StencilCoeffs]:
    """A hierarchy built by ``build_hierarchy(..., pad_levels=True)`` →
    a list of :class:`StencilCoeffs`, fine to coarse."""
    return [coeffs_from_numpy(c, device, dtype) for c in levels]


def coeffs3d_from_numpy(c, device, dtype) -> StencilCoeffs3D:
    """A ``StencilCoeffs3D``-like structure → :class:`StencilCoeffs3D`."""
    return StencilCoeffs3D(*(_tensor(getattr(c, f), device, dtype)
                             for f in StencilCoeffs3D._fields))


def spec3d_from_numpy(s, device, dtype) -> FluxSpec3D:
    """A ``FluxSpec3D``-like structure → :class:`FluxSpec3D`."""
    return FluxSpec3D(*(_tensor(getattr(s, f), device, dtype)
                        for f in FluxSpec3D._fields))


def levels3d_from_numpy(levels: Sequence, device,
                        dtype) -> List[StencilCoeffs3D]:
    """A hierarchy built by ``build_hierarchy_3d(..., pad_levels=True)`` →
    a list of :class:`StencilCoeffs3D`, fine to coarse."""
    return [coeffs3d_from_numpy(c, device, dtype) for c in levels]
