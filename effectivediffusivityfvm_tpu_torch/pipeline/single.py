"""Single-image simulation pipelines, 2-phase and 3-phase (torch port of
``effectivediffusivityfvm_tpu.pipeline.single``).

Re-design of the reference orchestration:
  * ``SingleSim``       (Deff2D.cuh:1635-1841): 2-phase, DCF continuation
  * ``SingleSim3Phase`` (Deff2D.cuh:1316-1633): 3-phase, DCG homotopy

Behavioral parity notes:
  * DCF continuation (2-phase): solves at DCF = 100, 100^2, ... clamped to
    the requested D_fluid, warm-starting each stage from the previous field
    (Deff2D.cuh:1759-1817).  The reference overwrites ``myImg`` each stage,
    so the *last* stage's Deff/conv wins — same here.  Documented departure:
    when D_fluid < 10 the reference's ``while(DCF <= DCF_Max)`` never
    executes and no solve happens at all (Deff2D.cuh:1761); here a single
    solve at the requested D_fluid always runs.
  * DCG homotopy (3-phase, hardcoded ``preCond=true`` Deff2D.cuh:1443):
    pre-stages at DCG = 10, 100, ... (< DCG) with tolerance x10 and
    MAX_ITER = 1e6 (Deff2D.cuh:1501-1502) whose results are NOT recorded
    (JacobiGPUPreCond never writes deff/conv/time, Deff2D.cuh:1150-1159),
    then the final solve at the true DCG with the original settings.
  * Deff normalization: divided by D_fluid (Deff2D.cuh:1802/1601).
  * ``Time`` = wall-clock of the recorded solve only, seconds.

Host work (decode, porosity, flood fill, classes) is numpy; the D field and
everything after it live on ``device`` (``"cuda"`` unless the caller asks
for ``"cpu"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from ..config import SimulationConfig
from ..io import images as img_io
from ..io import writers
from ..models import floodfill, phases
from ..ops import fvm
from ..ops.flux import make_flux_spec
from ..solvers.dispatch import needs_spd, solve as _dispatch_solve
from ..utils.logging import vprint
from ..utils.timing import time_fn

__all__ = ["SingleResult", "single_sim", "single_sim_3phase", "dcf_stages",
           "dcg_stages", "resolve_device", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the pipelines on the CPU")
    return dev


def torch_dtype(cfg: SimulationConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"Dtype must be float32 or float64, got {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


def _mgcg_kwargs(cfg):
    """mgcg-only kwargs (other solvers don't accept them)."""
    return {"first_window": cfg.first_window} if cfg.solver == "mgcg" else {}


@dataclasses.dataclass
class SingleResult:
    deff: float
    porosity: float
    path_flag: bool
    time_s: float
    n_elements: int
    conv: float
    iters: int
    x: np.ndarray
    svf: float = 0.0
    lvf: float = 0.0


def dcf_stages(d_fluid: float) -> List[float]:
    """DCF continuation ladder (Deff2D.cuh:1759-1817): 100^k clamped to
    d_fluid.  Always at least one stage (departure documented above)."""
    stages: List[float] = []
    count = 1
    dcf = 10.0
    while dcf <= d_fluid:
        dcf = math.pow(100.0, count)
        if dcf >= d_fluid:
            dcf = d_fluid
        stages.append(dcf)
        if dcf == d_fluid:
            break
        count += 1
    if not stages:
        stages = [d_fluid]
    return stages


def dcg_stages(d_gas: float) -> List[float]:
    """DCG homotopy pre-stages (Deff2D.cuh:1492-1549): 10, 100, ... < DCG."""
    stages: List[float] = []
    t = 10.0
    while t < d_gas:
        stages.append(t)
        t *= 10.0
    return stages


def _linear_init(ny: int, nx: int, c_left: float, c_right: float, dtype,
                 device) -> torch.Tensor:
    """Linear-gradient initial guess (Deff2D.cuh:1730-1734):
    ``x[i,j] = j/nx * (CR - CL) + CL``."""
    j = torch.arange(nx, dtype=dtype, device=device)
    row = j / nx * (c_right - c_left) + c_left
    return row.expand(ny, nx)


def single_sim(cfg: SimulationConfig, img: Optional[np.ndarray] = None,
               write_output: bool = True, device="cuda") -> SingleResult:
    """2-phase single-image pipeline (reference SingleSim, Deff2D.cuh:1635)."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    if img is None:
        img = img_io.load_grayscale(cfg.input_name)
    if img.ndim != 2:
        raise ValueError("please enter a grayscale image with 1 channel")

    poro = phases.porosity(img)
    vprint(cfg.verbose, f"Width = {img.shape[1]} Height = {img.shape[0]} Channel = 1")
    vprint(cfg.verbose, f"Porosity = {poro}")

    # Percolation screening on the original pixel grid (solid: pixel > 150,
    # Deff2D.cuh:1695).  2-phase mode uses only PathFlag; connectivity does
    # not mask the system (the reference frees Grid right after,
    # Deff2D.cuh:1705-1707).
    ff = floodfill.flood_fill(img > 150)

    classes = phases.amplify(phases.two_phase_classes(img), cfg.mesh_amp_y, cfg.mesh_amp_x)
    ny, nx = classes.shape

    x = _linear_init(ny, nx, cfg.c_left, cfg.c_right, dtype, dev)

    deff = float("nan")
    conv = float("nan")
    iters = 0
    time_s = 0.0
    for dcf in dcf_stages(cfg.d_fluid):
        d_field = torch.as_tensor(
            phases.d_field_from_classes(classes, dcf, cfg.d_solid,
                                        dtype=cfg.np_dtype), device=dev)
        coeffs = fvm.fvm_coefficients(d_field, cfg.c_left, cfg.c_right)
        spec = make_flux_spec(d_field, cfg.c_left, cfg.c_right)
        res, dt = time_fn(
            _dispatch_solve,
            cfg.solver,
            coeffs,
            spec,
            x,
            omega=cfg.omega,
            tol=cfg.convergence,
            max_iter=cfg.max_iter,
            check_every=cfg.check_every,
            criterion=cfg.criterion,
            **_mgcg_kwargs(cfg),
        )
        x = res.x
        deff = float(res.deff) / dcf
        conv = float(res.conv)
        iters = int(res.iters)
        time_s += dt
        vprint(cfg.verbose, f"Iterations taken = {iters}")
        vprint(cfg.verbose, f"DCF = {dcf}, Deff {deff}")

    x_np = x.cpu().numpy()
    result = SingleResult(
        deff=deff, porosity=poro, path_flag=ff.path_flag, time_s=time_s,
        n_elements=ny * nx, conv=conv, iters=iters, x=x_np,
    )
    if write_output:
        writers.write_single(
            cfg.output_name, cfg.input_name, poro, ff.path_flag, deff, time_s,
            ny * nx, conv, cfg.d_solid, cfg.d_fluid,
        )
        if cfg.print_cmap:
            writers.write_cmap(cfg.cmap_name, x_np)
    return result


def _solve3p(cfg, coeffs, spec, x, tol, max_iter, gas_np):
    """3-phase stage solve: routes 'dcg'/'dmg' (need the gas-component mask
    for their deflation coarse spaces) or the regular dispatch."""
    if cfg.solver == "dmg":
        from ..solvers.dmg import solve_dmg

        return solve_dmg(coeffs, spec, x, tol=tol, max_iter=max_iter,
                         check_every=cfg.check_every,
                         criterion=cfg.criterion, member=gas_np)
    if cfg.solver == "dcg":
        from ..solvers.deflation import solve_dcg

        return solve_dcg(coeffs, spec, x, tol=tol, max_iter=max_iter,
                         check_every=cfg.check_every, member=gas_np)
    return _dispatch_solve(
        cfg.solver, coeffs, spec, x,
        omega=cfg.omega, tol=tol, max_iter=max_iter,
        check_every=cfg.check_every, criterion=cfg.criterion,
        **_mgcg_kwargs(cfg),
    )


def single_sim_3phase(cfg: SimulationConfig, img: Optional[np.ndarray] = None,
                      write_output: bool = True, device="cuda") -> SingleResult:
    """3-phase single-image pipeline (reference SingleSim3Phase,
    Deff2D.cuh:1316)."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    if img is None:
        img = img_io.load_grayscale(cfg.input_name)
    if img.ndim != 2:
        raise ValueError("please enter a grayscale image with 1 channel")

    # Solid grid (pixel > 200, Deff2D.cuh:1368); flood fill marks isolated
    # (non-participating) pores, which join the solid in the identity mask
    # (Grid==1 or Grid==2, Deff2D.cuh:750-752).
    ff = floodfill.flood_fill(img > 200)
    classes = phases.amplify(phases.three_phase_classes(img), cfg.mesh_amp_y, cfg.mesh_amp_x)
    mask_np = phases.amplify(
        (img > 200) | ff.isolated, cfg.mesh_amp_y, cfg.mesh_amp_x
    )
    # gas-component coarse space for the deflated solvers (host preprocessing)
    gas_np = ((classes == phases.GAS) & ~mask_np
              if cfg.solver in ("dcg", "dmg") else None)
    ny, nx = classes.shape
    mask = torch.as_tensor(mask_np, device=dev)

    svf, lvf = phases.phase_fractions(classes)
    x = _linear_init(ny, nx, cfg.c_left, cfg.c_right, dtype, dev)

    def build(dcg_val):
        d_field = torch.as_tensor(
            phases.d_field_from_classes(classes, cfg.d_fluid, cfg.d_solid,
                                        dcg_val, dtype=cfg.np_dtype),
            device=dev)
        # Krylov solvers and the K3 kernel need the SPD (symmetrized)
        # masked assembly; identical solution (shared predicate with the
        # batch pipeline)
        coeffs = fvm.fvm_coefficients(
            d_field, cfg.c_left, cfg.c_right, mask=mask,
            symmetric=needs_spd(cfg.solver))
        spec = make_flux_spec(d_field, cfg.c_left, cfg.c_right)
        return coeffs, spec

    # Homotopy pre-stages: tol x10, MAX_ITER=1e6 (Deff2D.cuh:1501-1502);
    # results deliberately not recorded (JacobiGPUPreCond semantics).
    # The 1e6 cap is a Jacobi-era constant; Krylov solvers keep the user's
    # own cap.
    stage_max_iter = 1_000_000 if cfg.solver in ("jacobi", "rbsor", "jacobi_pallas") else cfg.max_iter
    # dmg is kappa-robust by construction (deflation + multigrid, f64): the
    # DCG homotopy ladder the reference needs to nurse Jacobi through the
    # contrast (Deff2D.cuh:1492-1549) is pure overhead for it -- skip the
    # pre-stages and solve the target system directly.
    stages = [] if cfg.solver == "dmg" else dcg_stages(cfg.d_gas)
    for stage_num, dcg_t in enumerate(stages, start=1):
        vprint(cfg.verbose, f"Pre-Cond Stage {stage_num}: DCG = {dcg_t:1.3e}")
        coeffs, spec = build(dcg_t)
        res = _solve3p(cfg, coeffs, spec, x, cfg.convergence * 10,
                       stage_max_iter, gas_np)
        x = res.x
        vprint(cfg.verbose, f"Iterations taken = {int(res.iters)}")

    # Final solve at the true DCG with original settings.
    coeffs, spec = build(cfg.d_gas)
    res, time_s = time_fn(
        _solve3p, cfg, coeffs, spec, x, cfg.convergence, cfg.max_iter,
        gas_np)
    x_np = res.x.cpu().numpy()
    deff = float(res.deff) / cfg.d_fluid   # Deff2D.cuh:1601
    vprint(cfg.verbose, f"Iterations taken = {int(res.iters)}")
    vprint(cfg.verbose, f"DCF = {cfg.d_fluid}, Deff {deff}")

    result = SingleResult(
        deff=deff, porosity=0.0, path_flag=ff.path_flag, time_s=time_s,
        n_elements=ny * nx, conv=float(res.conv), iters=int(res.iters), x=x_np,
        svf=svf, lvf=lvf,
    )
    if write_output:
        writers.write_single_3phase(
            cfg.output_name, cfg.input_name, svf, lvf, ff.path_flag, deff,
            time_s, ny * nx, float(res.conv), cfg.d_solid, cfg.d_fluid, cfg.d_gas,
        )
        if cfg.print_cmap:
            writers.write_cmap(cfg.cmap_name, x_np)
    return result
