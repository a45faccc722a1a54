"""3D voxel-domain simulation pipelines (torch port of
``effectivediffusivityfvm_tpu.pipeline.volume``).

Input is a ``(nz, ny, nx)`` uint8 voxel volume (e.g. a ``.npy`` micro-CT
stack) with the same grayscale phase conventions as 2D images.  The
pipelines mirror the 2D orchestration: porosity / phase fractions, 3D flood
fill screening, the diffusivity volume, DCF continuation (2-phase) or the
DCG homotopy (3-phase) with warm starts, and a solve on the 7-point
operator -- multigrid-PCG on K6/K7 (``Solver: mgcg``), deflated MGCG on
K6 (``dmg``, which takes each volume's gas components and skips the
homotopy pre-stages), diagonal-PCG (``cg``), red-black SOR (``rbsor``) or
weighted Jacobi.
Host work is numpy; the D volume and everything after it live on ``device``
(``"cuda"`` unless the caller asks for ``"cpu"``).

CSV output reuses the reference schemas with ``nElements`` = voxel count.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import defaultdict

import numpy as np
import torch

from ..config import SimulationConfig
from ..io import writers
from ..models import phases, volume
from ..ops import fvm3d
from ..solvers import solvers3d
from ..utils.logging import vprint
from ..utils.timing import time_fn
from .single import dcf_stages, dcg_stages, resolve_device, torch_dtype

__all__ = ["VolumeResult", "volume_sim", "volume_sim_3phase",
           "volume_batch_sim", "volume_batch_sim_3phase"]


@dataclasses.dataclass
class VolumeResult:
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


_SOLVERS = {
    "jacobi": solvers3d.solve_jacobi_3d,
    "rbsor": solvers3d.solve_rbsor_3d,
    "cg": solvers3d.solve_cg_3d,
    "mgcg": solvers3d.solve_mgcg_3d,
}

_BATCHED_SOLVERS = {
    "jacobi": solvers3d.solve_jacobi_3d_batched,
    "rbsor": solvers3d.solve_rbsor_3d_batched,
    "cg": solvers3d.solve_cg_3d_batched,
    "mgcg": solvers3d.solve_mgcg_3d_batched,
}


def _effective_solver_3d(cfg) -> str:
    """The 3D solver actually used: cgir/dcg/jacobi_pallas have no 3D
    variant and substitute mgcg -- loudly, and the symmetric-assembly flag
    follows the substitute.  ``dmg`` runs :mod:`..solvers.dmg3d`."""
    if cfg.solver in _SOLVERS or cfg.solver == "dmg":
        return cfg.solver
    warnings.warn(
        f"solver {cfg.solver!r} has no 3D implementation; using 'mgcg'",
        stacklevel=3)
    return "mgcg"


def _solve3d(cfg, coeffs, spec, x, tol, max_iter, name, batched=False,
             d_field=None, gas_np=None):
    """One (batched) volume solve; ``gas_np``: ``dmg``'s gas-component
    mask (a stack of them when batched), or ``None``."""
    kw = {}
    if name == "dmg":
        from ..solvers import dmg3d

        if batched:
            return dmg3d.solve_dmg_3d_batched(
                coeffs, spec, x, tol=tol, max_iter=max_iter,
                check_every=cfg.check_every, criterion=cfg.criterion,
                members=gas_np)
        return dmg3d.solve_dmg_3d(
            coeffs, spec, x, tol=tol, max_iter=max_iter,
            check_every=cfg.check_every, criterion=cfg.criterion,
            member=gas_np)
    if name == "mgcg":
        kw["first_window"] = cfg.first_window
        if d_field is not None:
            kw["d_field"] = d_field
    return (_BATCHED_SOLVERS if batched else _SOLVERS)[name](
        coeffs, spec, x, omega=cfg.omega, tol=tol, max_iter=max_iter,
        check_every=cfg.check_every, criterion=cfg.criterion, **kw)


def _linear_init_3d(nz, ny, nx, cl, cr, dtype, device):
    j = torch.arange(nx, dtype=dtype, device=device)
    return (j / nx * (cr - cl) + cl).expand(nz, ny, nx)


def _amplify(cfg, a):
    return volume.amplify_3d(a, cfg.mesh_amp_z, cfg.mesh_amp_y,
                             cfg.mesh_amp_x)


def _check_volume(vol):
    if vol.ndim != 3:
        raise ValueError("expected a (nz, ny, nx) voxel volume")


def volume_sim(cfg: SimulationConfig, vol: np.ndarray,
               write_output: bool = False, device="cuda") -> VolumeResult:
    """2-phase voxel pipeline with DCF continuation.  With ``Solver: mgcg``
    and ``Ds > 0`` the system is exactly the unmasked
    ``fvm_coefficients_3d(D)``, so K7 rebuilds level 0 from D
    (matrix-free)."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    _check_volume(vol)
    poro = volume.porosity_3d(vol)
    ff = volume.flood_fill_3d(vol > 150)
    classes = _amplify(cfg, phases.two_phase_classes(vol))
    nz, ny, nx = classes.shape
    x = _linear_init_3d(nz, ny, nx, cfg.c_left, cfg.c_right, dtype, dev)

    deff = conv = float("nan")
    iters = 0
    time_s = 0.0
    solver3d = _effective_solver_3d(cfg)
    mf_ok = solver3d == "mgcg" and cfg.d_solid > 0
    for dcf in dcf_stages(cfg.d_fluid):
        d_field = torch.as_tensor(phases.d_field_from_classes(
            classes, dcf, cfg.d_solid, dtype=cfg.np_dtype), device=dev)
        coeffs = fvm3d.fvm_coefficients_3d(d_field, cfg.c_left, cfg.c_right)
        spec = fvm3d.make_flux_spec_3d(d_field, cfg.c_left, cfg.c_right)
        res, dt = time_fn(_solve3d, cfg, coeffs, spec, x, cfg.convergence,
                          cfg.max_iter, solver3d,
                          d_field=d_field if mf_ok else None)
        x = res.x
        deff = float(res.deff) / dcf
        conv = float(res.conv)
        iters = int(res.iters)
        time_s += dt
        vprint(cfg.verbose, f"DCF = {dcf}, Deff {deff} ({iters} iters)")

    result = VolumeResult(deff=deff, porosity=poro, path_flag=ff.path_flag,
                          time_s=time_s, n_elements=classes.size, conv=conv,
                          iters=iters, x=x.cpu().numpy())
    if write_output:
        writers.write_single(cfg.output_name, cfg.input_name, poro,
                             ff.path_flag, deff, time_s, classes.size, conv,
                             cfg.d_solid, cfg.d_fluid)
    return result


def volume_sim_3phase(cfg: SimulationConfig, vol: np.ndarray,
                      write_output: bool = False,
                      device="cuda") -> VolumeResult:
    """3-phase voxel pipeline: solid/isolated masking + the DCG homotopy."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    _check_volume(vol)
    ff = volume.flood_fill_3d(vol > 200)
    classes = _amplify(cfg, phases.three_phase_classes(vol))
    mask_np = _amplify(cfg, (vol > 200) | ff.isolated)
    mask = torch.as_tensor(mask_np, device=dev)
    nz, ny, nx = classes.shape
    svf, lvf = phases.phase_fractions(classes)
    x = _linear_init_3d(nz, ny, nx, cfg.c_left, cfg.c_right, dtype, dev)

    solver3d = _effective_solver_3d(cfg)
    symmetric = solver3d in ("cg", "mgcg", "dmg")
    gas_np = (_amplify(cfg, phases.three_phase_classes(vol) == phases.GAS)
              & ~mask_np if solver3d == "dmg" else None)

    def build(dcg_val):
        d_field = torch.as_tensor(phases.d_field_from_classes(
            classes, cfg.d_fluid, cfg.d_solid, dcg_val, dtype=cfg.np_dtype),
            device=dev)
        coeffs = fvm3d.fvm_coefficients_3d(d_field, cfg.c_left, cfg.c_right,
                                           mask=mask, symmetric=symmetric)
        spec = fvm3d.make_flux_spec_3d(d_field, cfg.c_left, cfg.c_right)
        return coeffs, spec

    stage_max_iter = (1_000_000 if cfg.solver in ("jacobi", "rbsor")
                      else cfg.max_iter)
    # dmg is kappa-robust and skips the homotopy pre-stages (single.py)
    stages = [] if solver3d == "dmg" else dcg_stages(cfg.d_gas)
    for stage_num, dcg_t in enumerate(stages, start=1):
        vprint(cfg.verbose, f"Pre-Cond Stage {stage_num}: DCG = {dcg_t:1.3e}")
        coeffs, spec = build(dcg_t)
        res = _solve3d(cfg, coeffs, spec, x, cfg.convergence * 10,
                       stage_max_iter, solver3d)
        x = res.x

    coeffs, spec = build(cfg.d_gas)
    res, time_s = time_fn(_solve3d, cfg, coeffs, spec, x, cfg.convergence,
                          cfg.max_iter, solver3d, gas_np=gas_np)
    deff = float(res.deff) / cfg.d_fluid
    result = VolumeResult(deff=deff, porosity=0.0, path_flag=ff.path_flag,
                          time_s=time_s, n_elements=classes.size,
                          conv=float(res.conv), iters=int(res.iters),
                          x=res.x.cpu().numpy(), svf=svf, lvf=lvf)
    if write_output:
        writers.write_single_3phase(cfg.output_name, cfg.input_name, svf, lvf,
                                    ff.path_flag, deff, time_s, classes.size,
                                    float(res.conv), cfg.d_solid, cfg.d_fluid,
                                    cfg.d_gas)
    return result


# ---------------------------------------------------------------------------
# 3D batch mode: the voxel analog of pipeline/batch.py for micro-CT dataset
# generation
# ---------------------------------------------------------------------------

def _group_by_shape(vols, indices, max_group):
    buckets = defaultdict(list)
    for i in indices:
        buckets[vols[i].shape].append(i)
    groups = []
    for _, idxs in sorted(buckets.items()):
        if max_group <= 0:
            groups.append(idxs)
        else:
            groups.extend(idxs[k:k + max_group]
                          for k in range(0, len(idxs), max_group))
    return groups


def _batch_x0(cfg, shape, dtype, dev):
    bsz, nz, ny, nx = shape
    return _linear_init_3d(nz, ny, nx, cfg.c_left, cfg.c_right, dtype,
                           dev).expand(bsz, nz, ny, nx)


def volume_batch_sim(cfg: SimulationConfig, vols,
                     device="cuda") -> np.ndarray:
    """2-phase voxel batch: same-shape volumes stack to ``(B, nz, ny, nx)``
    and solve as one batched solve per group with per-volume convergence
    freezing; rows use the 2-phase batch schema with ``nElements`` = voxel
    count.  Incremental output/resume as in 2D."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    n = len(vols)
    out = np.zeros((n, 9))
    inc = (writers.IncrementalBatchWriter(cfg.output_name)
           if cfg.incremental_output else None)
    done = inc.completed() if inc else set()
    pending = [i for i in range(n) if i not in done]
    solver3d = _effective_solver_3d(cfg)

    for group in _group_by_shape(vols, pending, cfg.batch_size):
        stack = np.stack([vols[i] for i in group])
        stats = [(volume.porosity_3d(vols[i]),
                  volume.flood_fill_3d(vols[i] > 150).path_flag)
                 for i in group]
        classes = np.stack([_amplify(cfg, phases.two_phase_classes(v))
                            for v in stack])
        d_field = torch.as_tensor(phases.d_field_from_classes(
            classes, cfg.d_fluid, cfg.d_solid, dtype=cfg.np_dtype), device=dev)
        coeffs = fvm3d.fvm_coefficients_3d(d_field, cfg.c_left, cfg.c_right)
        spec = fvm3d.make_flux_spec_3d(d_field, cfg.c_left, cfg.c_right)
        x0 = _batch_x0(cfg, classes.shape, dtype, dev)
        res, dt = time_fn(
            _solve3d, cfg, coeffs, spec, x0, cfg.convergence, cfg.max_iter,
            solver3d, batched=True,
            # unmasked 2-phase operator: matrix-free level 0 (see volume_sim)
            d_field=d_field if (solver3d == "mgcg" and cfg.d_solid > 0)
            else None)
        deff = res.deff.cpu().numpy().astype(np.float64) / cfg.d_fluid
        conv = res.conv.cpu().numpy()
        iters = res.iters.cpu().numpy()
        tshare = dt * iters / max(float(iters.sum()), 1.0)
        for k, i in enumerate(group):
            poro, pf = stats[k]
            row = (i, poro, int(pf), float(deff[k]), float(tshare[k]),
                   classes[k].size, float(conv[k]), cfg.d_solid, cfg.d_fluid)
            out[i] = row
            if inc:
                inc.write_row(row)
            vprint(cfg.verbose, f"Volume {i} Deff {float(deff[k])}")
    if not cfg.incremental_output:
        writers.write_batch(cfg.output_name, [tuple(r) for r in out])
    return out


def volume_batch_sim_3phase(cfg: SimulationConfig, vols,
                            device="cuda") -> np.ndarray:
    """3-phase voxel batch with the DCG homotopy shared per group; optional
    per-volume ``CMAP_%05d.csv`` in ``X,Y,Z,C`` layout."""
    cfg.validate()
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    n = len(vols)
    out = np.zeros((n, 11))
    inc = (writers.IncrementalBatchWriter(cfg.output_name, three_phase=True)
           if cfg.incremental_output else None)
    done = inc.completed() if inc else set()
    pending = [i for i in range(n) if i not in done]
    solver3d = _effective_solver_3d(cfg)
    symmetric = solver3d in ("cg", "mgcg", "dmg")

    for group in _group_by_shape(vols, pending, cfg.batch_size):
        stack = np.stack([vols[i] for i in group])
        fills = [volume.flood_fill_3d(vols[i] > 200) for i in group]
        classes = np.stack([_amplify(cfg, phases.three_phase_classes(v))
                            for v in stack])
        mask_np = np.stack([_amplify(cfg, (v > 200) | ff.isolated)
                            for v, ff in zip(stack, fills)])
        mask = torch.as_tensor(mask_np, device=dev)
        gas_np = (np.stack([_amplify(cfg, phases.three_phase_classes(v)
                                     == phases.GAS) for v in stack])
                  & ~mask_np if solver3d == "dmg" else None)

        def build(dcg_val):
            d_field = torch.as_tensor(phases.d_field_from_classes(
                classes, cfg.d_fluid, cfg.d_solid, dcg_val,
                dtype=cfg.np_dtype), device=dev)
            coeffs = fvm3d.fvm_coefficients_3d(
                d_field, cfg.c_left, cfg.c_right, mask=mask,
                symmetric=symmetric)
            spec = fvm3d.make_flux_spec_3d(d_field, cfg.c_left, cfg.c_right)
            return coeffs, spec

        x = _batch_x0(cfg, classes.shape, dtype, dev)
        stage_max_iter = (1_000_000 if solver3d in ("jacobi", "rbsor")
                          else cfg.max_iter)
        stages = [] if solver3d == "dmg" else dcg_stages(cfg.d_gas)
        for stage_num, dcg_t in enumerate(stages, start=1):
            vprint(cfg.verbose,
                   f"Pre-Cond Stage {stage_num}: DCG = {dcg_t:1.3e}")
            coeffs, spec = build(dcg_t)
            res = _solve3d(cfg, coeffs, spec, x, cfg.convergence * 10,
                           stage_max_iter, solver3d, batched=True)
            x = res.x

        coeffs, spec = build(cfg.d_gas)
        res, dt = time_fn(_solve3d, cfg, coeffs, spec, x, cfg.convergence,
                          cfg.max_iter, solver3d, batched=True,
                          gas_np=gas_np)
        deff = res.deff.cpu().numpy().astype(np.float64) / cfg.d_fluid
        conv = res.conv.cpu().numpy()
        iters = res.iters.cpu().numpy()
        xs = res.x.cpu().numpy()
        tshare = dt * iters / max(float(iters.sum()), 1.0)
        fr = [phases.phase_fractions(c) for c in classes]
        for k, i in enumerate(group):
            row = (i, float(fr[k][0]), float(fr[k][1]),
                   int(fills[k].path_flag), float(deff[k]), float(tshare[k]),
                   classes[k].size, float(conv[k]), cfg.d_solid, cfg.d_fluid,
                   cfg.d_gas)
            out[i] = row
            if inc:
                inc.write_row(row)
            if cfg.print_cmap:
                writers.write_cmap_3d(f"CMAP_{i:05d}.csv", xs[k])
    if not cfg.incremental_output:
        writers.write_batch_3phase(cfg.output_name, [tuple(r) for r in out])
    return out
