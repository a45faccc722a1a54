"""Image ingestion: grayscale microstructure images -> numpy pixel grids
(the port's copy of ``effectivediffusivityfvm_tpu.io.images``).

Host-side equivalent of the reference's vendored ``stb_image.h`` decoder used
through ``stbi_load(..., req_comp=1)`` (readImage Deff2D.cuh:327-345,
readImageBatch Deff2D.cuh:362-380), with PIL as the decoder.  PIL is imported
only when an image is read, so the solvers run where it is not installed
(pass pixel arrays instead).

Also provides synthetic slab generators used by the analytical validation
oracles (documentation PDF §5.3).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

__all__ = [
    "load_grayscale",
    "batch_filenames",
    "load_batch",
    "parallel_slab",
    "series_slab",
    "three_phase_parallel_slab",
]


def load_grayscale(path: str) -> np.ndarray:
    """Load an image as a (H, W) uint8 grayscale array.

    Mirrors ``stbi_load`` with ``req_comp=1``: multi-channel images are
    converted with the same integer luma recipe stb uses
    ((r*77 + g*150 + b*29 + 0x80) >> 8), so pixel classes match the reference
    bit-for-bit on RGB inputs; 1-channel images pass through untouched.
    """
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("L", "I;16", "1"):
            arr = np.asarray(im.convert("L"), dtype=np.uint8)
        else:
            rgb = np.asarray(im.convert("RGB"), dtype=np.uint32)
            r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
            arr = ((r * 77 + g * 150 + b * 29 + 0x80) >> 8).astype(np.uint8)
    return arr


def batch_filenames(num_images: int, image_dir: str = ".") -> List[str]:
    """``%05d.jpg`` batch naming (BatchSim, Deff2D.cuh:1876)."""
    return [os.path.join(image_dir, f"{i:05d}.jpg") for i in range(num_images)]


def load_batch(num_images: int, image_dir: str = ".") -> List[np.ndarray]:
    return [load_grayscale(f) for f in batch_filenames(num_images, image_dir)]


# ---------------------------------------------------------------------------
# Synthetic analytical-oracle microstructures (documentation PDF §5.3):
# slabs aligned with (parallel) or across (series) the transport direction.
# Transport is along x (left->right Dirichlet).
# ---------------------------------------------------------------------------

def parallel_slab(n: int, eps: float) -> np.ndarray:
    """Fluid/solid slabs PARALLEL to transport: horizontal bands spanning x.

    Porosity ``eps`` of fluid (pixel 0), rest solid (pixel 255).
    Analytical: Deff = eps*Df + (1-eps)*Ds (PDF eq. 7).
    """
    img = np.full((n, n), 255, np.uint8)
    h = int(round(eps * n))
    img[:h, :] = 0
    return img


def series_slab(n: int, eps: float) -> np.ndarray:
    """Slabs IN SERIES with transport: vertical bands stacked along x.

    Analytical: Deff = (eps/Df + (1-eps)/Ds)^-1 (PDF eq. 8).
    """
    img = np.full((n, n), 255, np.uint8)
    w = int(round(eps * n))
    img[:, :w] = 0
    return img


def three_phase_parallel_slab(n: int, svf: float, lvf: float) -> np.ndarray:
    """3-phase parallel slabs: solid (255) / fluid (150) / gas (0) bands
    spanning x.  Analytical: Deff = LVF*Df + SVF*Ds + GVF*Dg (PDF eq. 9);
    the PDF §5.3.2 case is 30/40/30 with Dg = 1,237,500 -> Deff = 371,250.4.
    """
    img = np.zeros((n, n), np.uint8)  # gas by default
    hs = int(round(svf * n))
    hf = int(round(lvf * n))
    img[:hs, :] = 255
    img[hs:hs + hf, :] = 150
    return img
