"""Simulation configuration (the port's copy of
``effectivediffusivityfvm_tpu.config``, which is numpy-only but cannot be
imported without JAX).

A re-design of the reference's ``options`` struct and ``input.txt`` parser
(reference: Deff2D.cuh:18-37 ``options``, Deff2D.cuh:234-324
``readInputFile``, Deff2D.cuh:121-175 ``printOptions``).

The same 17 ``Key: value`` keys are accepted, order-independent, unknown keys
ignored, so an existing reference ``input.txt`` drops in unchanged.  On top of
that the dataclass carries the JAX package's extra knobs (dtype, solver
choice, check cadence, sharding).  The fields, keys and validation are the
JAX package's exactly, so every ``input.txt`` it accepts parses here and
runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SimulationConfig", "parse_input_file", "format_options"]


@dataclasses.dataclass
class SimulationConfig:
    # ---- reference-compatible options (Deff2D.cuh:18-37) ----
    n_phase: int = 2                  # "Phases:"     (opts.nPhase)
    d_solid: float = 0.0              # "Ds:"         (opts.DCsolid)
    d_fluid: float = 1.0              # "Df:"         (opts.DCfluid)
    d_gas: float = 1.0                # "Dg:"         (opts.DCgas)
    mesh_amp_x: int = 1               # "MeshAmpX:"   (opts.MeshIncreaseX)
    mesh_amp_y: int = 1               # "MeshAmpY:"   (opts.MeshIncreaseY)
    mesh_amp_z: int = 1               # "MeshAmpZ:"   voxel-depth amplification
                                      #   (3D pipelines)
    input_name: str = "00000.jpg"     # "InputName:"  (opts.inputFilename)
    c_right: float = 1.0              # "CR:"         (opts.CRight)
    c_left: float = 0.0               # "CL:"         (opts.CLeft)
    output_name: str = "output.csv"   # "OutputName:" (opts.outputFilename)
    print_cmap: bool = False          # "printCMap:"  (opts.printCmap)
    cmap_name: str = "CMAP.csv"       # "CMapName:"   (opts.CMapName)
    convergence: float = 1e-5         # "Convergence:" (opts.ConvergeCriteria)
    max_iter: int = 500_000           # "MaxIter:"    (opts.MAX_ITER)
    verbose: bool = False             # "Verbose:"    (opts.verbose)
    batch_flag: bool = False          # "RunBatch:"   (opts.BatchFlag)
    num_images: int = 0               # "NumImages:"  (opts.NumImg)

    # ---- extensions of the JAX package (no reference equivalent) ----
    dtype: str = "float32"            # compute dtype on device ("float32"/"float64")
    solver: str = "jacobi"            # jacobi|rbsor|cg|mgcg|cgir|dcg|dmg|jacobi_pallas
    check_every: int = 0              # convergence-check cadence in iterations;
                                      #   0 = per-solver default (sweep solvers:
                                      #   10000, the reference's hardcoded
                                      #   iterToCheck, Deff2D.cuh:1174; mgcg: 10).
                                      #   An explicit value is honoured exactly.
    omega: float = 0.0                # relaxation factor; 0 = solver default
                                      #   (jacobi: 2/3, the reference's hardcoded
                                      #    weight Deff2D.cuh:72)
    criterion: str = "deff"           # "deff" (reference) | "residual" | "relresidual"
    image_dir: str = "."              # directory holding %05d.jpg batch images
    batch_size: int = 0               # 0 = solve each same-shape group at once
    incremental_output: bool = True   # write batch CSV rows as they complete
                                      #   (fixes reference all-or-nothing, PDF §3.6)
    use_floodfill_native: bool = True # read by no pipeline, as in the JAX
                                      #   package; flood_fill's own
                                      #   use_native defaults to the C++ route
    seed_both_boundaries: bool = True # flood-fill seeding intent (Deff2D.cuh:593-605)
    compact_batches: bool = False     # re-pack active images between solve
                                      #   segments (cg/mgcg, solvers/compact.py)
    devices: int = 1                  # devices for the pipeline: 1 = one device,
                                      #   -1 = all visible, n = first n
    dp: int = 0                       # data-parallel extent; 0 = devices//sp
    sp: int = 1                       # spatial (row-sharded) extent
    pallas: str = "auto"              # fused-kernel selection for solver=mgcg:
                                      #   "auto" picks by size (K4/K5 past
                                      #   the whole-cycle size), "force" is
                                      #   K1/K2, "off" the plain torch cycle
                                      #   under run_pcg, "interpret" K1/K2's
                                      #   plain versions (batch pipelines)
    first_window: int = 0             # "FirstWindow:" — iterations in the FIRST
                                      #   fused-mgcg window.  0 = auto:
                                      #   check_every for the residual/
                                      #   relresidual criteria, 1 for
                                      #   criterion=deff (no in-kernel stop).
                                      #   Explicit values are honoured as-is.

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    def validate(self) -> None:
        if self.n_phase not in (2, 3):
            raise ValueError(f"Phases must be 2 or 3, got {self.n_phase}")
        if self.mesh_amp_x < 1 or self.mesh_amp_y < 1 or self.mesh_amp_z < 1:
            # reference: Deff2D.cuh:1672-1675
            raise ValueError("MeshAmp has to be an integer >= 1")
        if self.solver not in ("jacobi", "rbsor", "cg", "mgcg", "cgir", "dcg",
                               "dmg", "jacobi_pallas"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.solver in ("cgir", "dmg") and self.dtype != "float64":
            raise ValueError(
                f"solver {self.solver!r} runs f64 outer arithmetic; "
                "set Dtype: float64")
        if self.criterion not in ("deff", "residual", "relresidual"):
            raise ValueError(f"unknown criterion {self.criterion!r}")
        if self.pallas not in ("auto", "off", "force", "interpret"):
            raise ValueError(f"unknown pallas mode {self.pallas!r}")
        if self.devices == 0 or self.devices < -1:
            raise ValueError(f"Devices must be -1 (all) or >= 1, got {self.devices}")
        if self.dp < 0 or self.sp < 1:
            raise ValueError(f"need dp >= 0 and sp >= 1, got dp={self.dp} sp={self.sp}")
        if self.first_window < 0:
            raise ValueError(
                f"FirstWindow must be >= 0 (0 = auto), got {self.first_window}")

    def resolve_mesh_shape(self, n_visible: int) -> tuple:
        """Resolve (n_devices, dp, sp) against the visible device count."""
        n = n_visible if self.devices == -1 else self.devices
        if n > n_visible:
            raise ValueError(f"Devices: {n} requested, {n_visible} visible")
        sp = self.sp
        dp = self.dp if self.dp else max(n // sp, 1)
        if dp * sp != n:
            raise ValueError(f"dp*sp = {dp}*{sp} != Devices = {n}")
        return n, dp, sp


# key in input.txt -> (field name, converter)
_KEYMAP = {
    "Phases:": ("n_phase", int),
    "Ds:": ("d_solid", float),
    "Df:": ("d_fluid", float),
    "Dg:": ("d_gas", float),
    "MeshAmpX:": ("mesh_amp_x", int),
    "MeshAmpY:": ("mesh_amp_y", int),
    "MeshAmpZ:": ("mesh_amp_z", int),
    "InputName:": ("input_name", str),
    "CR:": ("c_right", float),
    "CL:": ("c_left", float),
    "OutputName:": ("output_name", str),
    "printCMap:": ("print_cmap", lambda v: bool(int(float(v)))),
    "CMapName:": ("cmap_name", str),
    "Convergence:": ("convergence", float),
    "MaxIter:": ("max_iter", lambda v: int(float(v))),
    "Verbose:": ("verbose", lambda v: bool(int(float(v)))),
    "RunBatch:": ("batch_flag", lambda v: bool(int(float(v)))),
    "NumImages:": ("num_images", int),
    # extensions, accepted from the same file for convenience
    "Dtype:": ("dtype", str),
    "Solver:": ("solver", str),
    "CheckEvery:": ("check_every", lambda v: int(float(v))),
    "Omega:": ("omega", float),
    "Criterion:": ("criterion", str),
    "ImageDir:": ("image_dir", str),
    "BatchSize:": ("batch_size", lambda v: int(float(v))),
    "Compact:": ("compact_batches", lambda v: bool(int(float(v)))),
    "Devices:": ("devices", lambda v: int(float(v))),
    "DP:": ("dp", lambda v: int(float(v))),
    "SP:": ("sp", lambda v: int(float(v))),
    "Pallas:": ("pallas", str),
    "FirstWindow:": ("first_window", lambda v: int(float(v))),
}


def parse_input_file(path: str, base: Optional[SimulationConfig] = None) -> SimulationConfig:
    """Parse a reference-format ``input.txt`` into a :class:`SimulationConfig`.

    Line-oriented ``Key: value`` pairs, order-independent, unknown keys ignored
    (reference: Deff2D.cuh:234-324).  Unlike the reference, missing keys fall
    back to well-defined defaults instead of uninitialized struct members.
    """
    cfg = dataclasses.replace(base) if base is not None else SimulationConfig()
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            key, value = parts[0], parts[1].split()[0] if parts[1].split() else ""
            if key in _KEYMAP and value != "":
                field, conv = _KEYMAP[key]
                setattr(cfg, field, conv(value))
    cfg.validate()
    return cfg


def format_options(cfg: SimulationConfig) -> str:
    """Verbose echo of the options (reference: printOptions, Deff2D.cuh:121-175)."""
    lines = ["--------------------------------------", ""]
    if not cfg.batch_flag:
        lines += ["Current selected options:", "", "--------------------------------------"]
    else:
        lines += ["Running Image Batch:", ""]
    lines += [
        f"Number of Phases = {cfg.n_phase}",
        f"DC Fluid = {cfg.d_fluid:1.3e}",
        f"DC Solid = {cfg.d_solid:1.3e}",
        f"DC Gas = {cfg.d_gas:1.3e}",
        f"Concentration Left = {cfg.c_left:.2f}",
        f"Concentration Right = {cfg.c_right:.2f}",
        f"Mesh Amp. X = {cfg.mesh_amp_x}",
        f"Mesh Amp. Y = {cfg.mesh_amp_y}",
        f"Maximum Iterations = {cfg.max_iter}",
        f"Convergence = {cfg.convergence:.10f}",
    ]
    if not cfg.batch_flag:
        lines.append(f"Name of input image: {cfg.input_name}")
        lines.append(f"Name of output file: {cfg.output_name}")
        if not cfg.print_cmap:
            lines.append("Print Concentration Map = False")
        else:
            lines.append(f"Concentration Map Name = {cfg.cmap_name}")
    else:
        lines.append(f"Name of output file: {cfg.output_name}")
        lines.append(f"Number of files to run: {cfg.num_images}")
        if cfg.print_cmap:
            lines.append("Printing Concentration Distribution for all images.")
        else:
            lines.append("No Concentration maps will be printed.")
    lines += [
        f"Solver = {cfg.solver} (dtype={cfg.dtype}, omega={cfg.omega:.6f}, "
        f"check_every={cfg.check_every}, criterion={cfg.criterion})",
        "--------------------------------------",
        "",
    ]
    return "\n".join(lines)
