"""Post-processing visualization (torch port of
``effectivediffusivityfvm_tpu.viz``; the reference's contourC.py).

Renders the source microstructure image next to a contour plot of the
concentration field from a CMAP CSV.  Improvements over the reference script:
dimensions are read from the CSV itself instead of hardcoded
(contourC.py:10-11), and the solid mask threshold is configurable
(contourC.py:34-43 hardcodes 1e-9 and loops in Python; this is vectorized).
The readers need numpy only; matplotlib is imported inside the plot
functions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["read_cmap", "plot_concentration", "read_cmap_3d",
           "plot_volume_slices"]


def read_cmap(path: str) -> np.ndarray:
    """Read an ``X,Y,C`` CMAP CSV back into a (ny, nx) array."""
    data = np.genfromtxt(path, delimiter=",", names=True)
    xs = data["X"].astype(int)
    ys = data["Y"].astype(int)
    nx, ny = xs.max() + 1, ys.max() + 1
    field = np.zeros((ny, nx))
    field[ys, xs] = data["C"]
    return field


def plot_concentration(cmap_path: str, image_path: Optional[str] = None,
                       solid_tol: float = 1e-9, out_path: Optional[str] = None,
                       levels: int = 40):
    """Side-by-side image + concentration contour (contourC.py:51-69)."""
    import matplotlib
    if out_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = read_cmap(cmap_path)
    c = np.ma.array(c, mask=c < solid_tol)
    ny, nx = c.shape
    xp, yp = np.meshgrid(np.linspace(0, nx, nx), np.linspace(ny, 0, ny))

    ncols = 2 if image_path else 1
    fig, axes = plt.subplots(1, ncols, constrained_layout=True, figsize=(8, 7), dpi=100)
    axes = np.atleast_1d(axes)
    k = 0
    if image_path:
        from .io.images import load_grayscale
        axes[0].imshow(load_grayscale(image_path), cmap="gray")
        axes[0].set_title(image_path)
        axes[0].set_aspect("equal")
        k = 1
    cs = axes[k].contourf(xp, yp, c, levels, cmap=plt.cm.inferno)
    fig.colorbar(cs, ax=axes[k])
    axes[k].set_title("Concentration Contour")
    axes[k].set_xlabel("x")
    axes[k].set_ylabel("y")
    axes[k].set_aspect("equal")

    if out_path is not None:
        fig.savefig(out_path)
        plt.close(fig)
    else:
        plt.show()
    return fig


def read_cmap_3d(path: str) -> np.ndarray:
    """Read an ``X,Y,Z,C`` 3D CMAP CSV back into a (nz, ny, nx) array."""
    data = np.genfromtxt(path, delimiter=",", names=True)
    xs = data["X"].astype(int)
    ys = data["Y"].astype(int)
    zs = data["Z"].astype(int)
    field = np.zeros((zs.max() + 1, ys.max() + 1, xs.max() + 1))
    field[zs, ys, xs] = data["C"]
    return field


def plot_volume_slices(cmap_path: str, solid_tol: float = 1e-9,
                       out_path: Optional[str] = None, levels: int = 40):
    """Mid-plane slices (xy, xz, yz) of a 3D concentration field — the
    volume analog of :func:`plot_concentration` (no reference equivalent;
    3D mode is a framework extension)."""
    import matplotlib
    if out_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = read_cmap_3d(cmap_path)
    nz, ny, nx = c.shape
    cuts = [(c[nz // 2], "xy (z mid)", "x", "y"),
            (c[:, ny // 2, :], "xz (y mid)", "x", "z"),
            (c[:, :, nx // 2], "yz (x mid)", "y", "z")]
    fig, axes = plt.subplots(1, 3, constrained_layout=True,
                             figsize=(13, 4.2), dpi=100)
    for ax, (plane, title, xl, yl) in zip(axes, cuts):
        masked = np.ma.array(plane, mask=plane < solid_tol)
        cs = ax.contourf(masked, levels, cmap=plt.cm.inferno)
        fig.colorbar(cs, ax=ax)
        ax.set_title(title)
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_aspect("equal")
    if out_path is not None:
        fig.savefig(out_path)
        plt.close(fig)
    else:
        plt.show()
    return fig
