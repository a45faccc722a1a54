"""Batch (ML dataset generation) pipelines, single-device part (torch port
of ``effectivediffusivityfvm_tpu.pipeline.batch``).

Re-design of the reference batch modes:
  * ``BatchSim``       (Deff2D.cuh:1843-2054): 2-phase, single solve per image
    at the requested D_fluid (no DCF continuation), 9 output values per image;
  * ``BatchSim3Phase`` (Deff2D.cuh:2056-2419): 3-phase, DCG homotopy per
    image, 10 values per image, optional per-image ``CMAP_%05d.csv``.

The reference processes images strictly serially and re-allocates all GPU
buffers per image (Deff2D.cuh:1867/1975).  Here images are grouped by shape,
stacked to ``(B, ny, nx)``, and solved together per group on one device.
Per-image convergence is preserved exactly: a converged image's field
freezes while the rest keep sweeping (see ``solvers/driver.run_batched``).

Checkpoint/resume (fixes the reference's documented all-or-nothing
limitation, PDF §3.6): with ``cfg.incremental_output`` rows are flushed per
completed group and a rerun resumes after the last finished image.

Host/device pipelining: group k+1's host preprocessing (stack, porosity,
flood fill) runs on a worker thread while the device solves group k
(:func:`_prefetched`).

Multi-device placement (``Devices``/``DP``/``SP``): a shape group is
solved on a ``(dp, sp)`` mesh of torch devices (:mod:`..parallel.mesh`),
the devices given by the caller's ``mesh_devices`` (default: every visible
CUDA device; a device may repeat).  ``SP: 1`` splits the batch over dp and
runs the regular batched solver on each chunk's device; ``SP > 1`` also
splits the rows and runs the sharded solvers (``jacobi``, ``mgcg``).
The deflated solvers (``dcg``, ``dmg``) take each image's gas-component
mask, on one device and on each dp chunk of a mesh alike.

``Compact: 1`` with ``cg`` or ``mgcg`` on one device advances a 2-phase
group in segments and re-packs the active images between them
(:mod:`..solvers.compact`).  ``Pallas:`` maps as the JAX package maps it:
``force`` runs the "cgstep" engine (K1/K2) at every size, ``auto`` lets the
solver choose (the banded K4/K5 engine for float32 grids past the
whole-cycle size), ``off`` runs the plain torch cycle under ``run_pcg``
(``use_pallas=False``), and ``interpret`` runs the "cgstep" engine on the
kernels' plain versions (``plain=True``), the counterpart of the JAX
package's interpreter mode.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SimulationConfig
from ..io import images as img_io
from ..io import writers
from ..models import floodfill, phases
from ..ops import fvm
from ..ops.flux import BoundaryFluxSpec, make_flux_spec
from ..solvers.dispatch import needs_spd, solve_batched
from ..solvers.driver import SolveResult
from ..utils.logging import vprint
from ..utils.timing import time_fn
from .single import _linear_init, dcg_stages, resolve_device, torch_dtype

__all__ = ["batch_sim", "batch_sim_3phase", "solve_image_group",
           "solve_image_group_3phase"]


_PALLAS_KW = {"auto": {}, "force": dict(use_pallas="cgstep"),
              "off": dict(use_pallas=False),
              "interpret": dict(use_pallas="cgstep", plain=True)}


def _solver_kwargs(cfg: SimulationConfig, tol: float, max_iter: int) -> dict:
    kw = dict(omega=cfg.omega, tol=tol, max_iter=max_iter,
              check_every=cfg.check_every, criterion=cfg.criterion)
    if cfg.solver == "mgcg":
        kw.update(first_window=cfg.first_window, **_PALLAS_KW[cfg.pallas])
    return kw


# ---------------------------------------------------------------------------
# Multi-device placement
# ---------------------------------------------------------------------------

def _pipeline_mesh(cfg: SimulationConfig, dev, mesh_devices=None):
    """The pipeline's ``(dp, sp)`` mesh, or ``None`` for one device.

    ``cfg.devices`` (``Devices:``) counts the devices a shape group spreads
    over, out of ``mesh_devices`` (default: every visible CUDA device when
    the pipeline runs on CUDA, else ``[dev]``)."""
    if cfg.devices == 1 and cfg.sp == 1 and cfg.dp in (0, 1):
        return None
    from ..parallel.mesh import default_devices, make_mesh

    if mesh_devices is None:
        mesh_devices = default_devices() if dev.type == "cuda" else [dev]
    n, dp, sp = cfg.resolve_mesh_shape(len(mesh_devices))
    if n == 1:
        return None
    return make_mesh(n, dp=dp, sp=sp, devices=mesh_devices)


def _pad_batch(tree, mult: int):
    """Edge-pad the batch axis of ``(coeffs, spec, x0)`` to a multiple of
    ``mult`` (padded entries copy the last image: they solve identically
    and are dropped on the way out)."""
    coeffs, spec, x0 = tree
    bsz = x0.shape[0]
    pad = (-bsz) % mult
    if pad == 0:
        return tree, bsz

    def pad_one(a):
        return torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])

    return (fvm.StencilCoeffs(*map(pad_one, coeffs)),
            BoundaryFluxSpec(*map(pad_one, spec)), pad_one(x0)), bsz


def _deflated_batched(cfg, coeffs, spec, x0, tol, max_iter, members):
    """The batched ``dmg``/``dcg`` solve with per-image gas masks."""
    if cfg.solver == "dmg":
        from ..solvers.dmg import solve_dmg_batched

        return solve_dmg_batched(coeffs, spec, x0, tol=tol,
                                 max_iter=max_iter,
                                 check_every=cfg.check_every,
                                 criterion=cfg.criterion, members=members)
    from ..solvers.deflation import solve_dcg_batched

    return solve_dcg_batched(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                             check_every=cfg.check_every, members=members)


def _solve_group_dp_shardmap(cfg, mesh, coeffs, spec, x0, tol, max_iter,
                             members=None):
    """The dp-only group solve: dp chunk ``d`` of the batch runs the regular
    batched solver (its CUDA kernels included) on mesh device ``d``; the
    deflated solvers take the chunk's slice of ``members``.  Each image's
    solve is independent of the others in its batch, so the result equals
    the single-device run of the same images."""
    bl = x0.shape[0] // mesh.dp
    kw = _solver_kwargs(cfg, tol, max_iter)
    parts = []
    for d in range(mesh.dp):
        dev = mesh.devices[d]
        sl = slice(d * bl, (d + 1) * bl)
        args = (fvm.StencilCoeffs(*(a[sl].to(dev) for a in coeffs)),
                BoundaryFluxSpec(*(a[sl].to(dev) for a in spec)),
                x0[sl].to(dev))
        if cfg.solver in ("dcg", "dmg"):
            parts.append(_deflated_batched(
                cfg, *args, tol, max_iter,
                None if members is None else members[sl]))
        else:
            parts.append(solve_batched(cfg.solver, *args, **kw))
    return SolveResult(*(torch.cat([getattr(r, f).to(x0.device)
                                    for r in parts])
                         for f in SolveResult._fields))


def _solve_group_on_mesh(cfg, mesh, coeffs, spec, x0, tol, max_iter,
                         gas_np=None):
    """Run one shape group's batched solve on the pipeline mesh.

    ``sp == 1``: the batch split over dp (:func:`_solve_group_dp_shardmap`;
    ``gas_np``, the per-image gas masks of the deflated solvers, padded as
    the batch is).  ``sp > 1``: the rows split too, through the sharded
    Jacobi or MGCG solver (``jacobi``/``mgcg`` only)."""
    dp, sp = mesh.dp, mesh.sp
    (coeffs, spec, x0), bsz = _pad_batch((coeffs, spec, x0), dp)
    if sp > 1:
        if cfg.solver not in ("jacobi", "mgcg"):
            raise ValueError(
                f"SP: {sp} in batch mode supports solver=jacobi (halo sweep) "
                f"or solver=mgcg (sharded multigrid-PCG); got {cfg.solver!r} "
                f"— use SP: 1 (pure dp) for other solvers")
        ny = x0.shape[-2]
        if ny % sp:
            raise ValueError(f"image rows ({ny}) must divide SP ({sp})")
        if cfg.solver == "mgcg":
            from ..parallel.halo import sharded_solve_mgcg

            res = sharded_solve_mgcg(
                coeffs, spec, x0, mesh, tol=tol, max_iter=max_iter,
                check_every=cfg.check_every or 10, criterion=cfg.criterion,
                first_window=cfg.first_window)
        else:
            from ..parallel.halo import sharded_solve_jacobi

            res = sharded_solve_jacobi(
                coeffs, spec, x0, mesh, omega=cfg.omega or 2.0 / 3.0, tol=tol,
                max_iter=max_iter,
                check_every=cfg.check_every or 10_000, criterion=cfg.criterion)
    else:
        members = None
        if gas_np is not None:
            pad = x0.shape[0] - bsz
            members = np.concatenate(
                [gas_np, np.repeat(gas_np[-1:], pad, axis=0)]) if pad else gas_np
        res = _solve_group_dp_shardmap(cfg, mesh, coeffs, spec, x0, tol,
                                       max_iter, members)
    return SolveResult(*(a[:bsz] for a in res))


def _group_by_shape(imgs: Sequence[np.ndarray], indices: Sequence[int],
                    max_group: int) -> List[List[int]]:
    """Bucket image indices by (H, W); split buckets larger than max_group."""
    buckets: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i in indices:
        buckets[imgs[i].shape].append(i)
    groups: List[List[int]] = []
    for _, idxs in sorted(buckets.items()):
        if max_group <= 0:
            groups.append(idxs)
        else:
            groups.extend(idxs[k:k + max_group] for k in range(0, len(idxs), max_group))
    return groups


def solve_image_group(cfg: SimulationConfig, imgs_np: np.ndarray,
                      device="cuda", mesh_devices=None):
    """2-phase batched solve of one same-shape group (on the pipeline mesh
    when ``Devices``/``DP``/``SP`` ask for one, see :func:`_pipeline_mesh`).

    Args:
      imgs_np: (B, H, W) uint8 pixels.
    Returns:
      (deff, conv, iters, x_fields, time_s) with leading batch dim (numpy).
    """
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    classes = np.stack([
        phases.amplify(phases.two_phase_classes(im), cfg.mesh_amp_y, cfg.mesh_amp_x)
        for im in imgs_np
    ])
    bsz, ny, nx = classes.shape
    d_field = torch.as_tensor(
        phases.d_field_from_classes(classes, cfg.d_fluid, cfg.d_solid,
                                    dtype=cfg.np_dtype), device=dev)
    coeffs = fvm.fvm_coefficients(d_field, cfg.c_left, cfg.c_right)
    spec = make_flux_spec(d_field, cfg.c_left, cfg.c_right)
    x0 = _linear_init(ny, nx, cfg.c_left, cfg.c_right, dtype, dev).expand(
        bsz, ny, nx)
    mesh = _pipeline_mesh(cfg, dev, mesh_devices)
    if mesh is not None:
        res, dt = time_fn(_solve_group_on_mesh, cfg, mesh, coeffs, spec, x0,
                          cfg.convergence, cfg.max_iter)
    elif cfg.compact_batches and cfg.solver in ("cg", "mgcg"):
        from ..solvers.compact import solve_batched_compacted
        from ..solvers.dispatch import _lookup

        res, dt = time_fn(solve_batched_compacted,
                          _lookup(cfg.solver, batched=True), coeffs, spec,
                          x0, **_solver_kwargs(cfg, cfg.convergence,
                                               cfg.max_iter))
    else:
        res, dt = time_fn(solve_batched, cfg.solver, coeffs, spec, x0,
                          **_solver_kwargs(cfg, cfg.convergence,
                                           cfg.max_iter))
    deff = res.deff.cpu().numpy().astype(np.float64) / cfg.d_fluid  # Deff2D.cuh:2017
    return (deff, res.conv.cpu().numpy(), res.iters.cpu().numpy(),
            res.x.cpu().numpy(), dt)


def solve_image_group_3phase(cfg: SimulationConfig, imgs_np: np.ndarray,
                             device="cuda", mesh_devices=None):
    """3-phase batched solve of one same-shape group, DCG homotopy included
    (stage ladder depends only on the global DCG, so all images share it);
    on the pipeline mesh as :func:`solve_image_group`."""
    dev = resolve_device(device)
    mesh = _pipeline_mesh(cfg, dev, mesh_devices)

    def solve(coeffs, spec, x, tol, max_iter):
        # dcg/dmg take the per-image gas-component masks for their
        # deflation spaces (as single._solve3p does for one image)
        if mesh is not None:
            return _solve_group_on_mesh(cfg, mesh, coeffs, spec, x, tol,
                                        max_iter, gas_np=gas_np)
        if cfg.solver in ("dcg", "dmg"):
            return _deflated_batched(cfg, coeffs, spec, x, tol, max_iter,
                                     gas_np)
        return solve_batched(cfg.solver, coeffs, spec, x,
                             **_solver_kwargs(cfg, tol, max_iter))

    dtype = torch_dtype(cfg)
    class_list, mask_list = [], []
    for im in imgs_np:
        ff = floodfill.flood_fill(im > 200)
        class_list.append(
            phases.amplify(phases.three_phase_classes(im), cfg.mesh_amp_y, cfg.mesh_amp_x)
        )
        mask_list.append(
            phases.amplify((im > 200) | ff.isolated, cfg.mesh_amp_y, cfg.mesh_amp_x)
        )
    classes = np.stack(class_list)
    mask_np = np.stack(mask_list)
    mask = torch.as_tensor(mask_np, device=dev)
    gas_np = ((classes == phases.GAS) & ~mask_np
              if cfg.solver in ("dcg", "dmg") else None)
    bsz, ny, nx = classes.shape

    def build(dcg_val):
        d_field = torch.as_tensor(
            phases.d_field_from_classes(
                classes, cfg.d_fluid, cfg.d_solid, dcg_val,
                dtype=cfg.np_dtype), device=dev)
        return (
            fvm.fvm_coefficients(d_field, cfg.c_left, cfg.c_right, mask=mask,
                                 symmetric=needs_spd(cfg.solver)),
            make_flux_spec(d_field, cfg.c_left, cfg.c_right),
        )

    x = _linear_init(ny, nx, cfg.c_left, cfg.c_right, dtype, dev).expand(
        bsz, ny, nx)
    stage_max_iter = (1_000_000 if cfg.solver in ("jacobi", "rbsor", "jacobi_pallas")
                      else cfg.max_iter)
    # dmg skips the homotopy pre-stages (kappa-robust; see single.py)
    stages = [] if cfg.solver == "dmg" else dcg_stages(cfg.d_gas)
    for stage_num, dcg_t in enumerate(stages, start=1):
        vprint(cfg.verbose, f"Pre-Cond Stage {stage_num}: DCG = {dcg_t:1.3e}")
        coeffs, spec = build(dcg_t)
        res = solve(coeffs, spec, x, cfg.convergence * 10, stage_max_iter)
        x = res.x

    coeffs, spec = build(cfg.d_gas)
    res, dt = time_fn(solve, coeffs, spec, x, cfg.convergence, cfg.max_iter)
    deff = res.deff.cpu().numpy().astype(np.float64) / cfg.d_fluid
    fr = [phases.phase_fractions(c) for c in classes]
    svf = np.asarray([f[0] for f in fr])
    lvf = np.asarray([f[1] for f in fr])
    return (deff, res.conv.cpu().numpy(), res.iters.cpu().numpy(),
            res.x.cpu().numpy(), dt, svf, lvf)


def _prefetched(groups, prepare):
    """Yield ``(group, prepare(group))`` with the next group's host
    preprocessing overlapped with the caller's device work on the current
    one (single worker thread)."""
    if not groups:
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prepare, groups[0])
        for i, group in enumerate(groups):
            data = fut.result()
            if i + 1 < len(groups):
                fut = pool.submit(prepare, groups[i + 1])
            yield group, data


def _attribute_time(total_s: float, iters: np.ndarray) -> np.ndarray:
    """Per-image Time attribution for a group solve: proportional to each
    image's sweep count (the reference reports true per-image GPU time; a
    batch has one wall-clock, split by work done)."""
    tot = float(np.sum(iters))
    if tot <= 0:
        return np.full(iters.shape, total_s / max(len(iters), 1))
    return total_s * np.asarray(iters, np.float64) / tot


def batch_sim(cfg: SimulationConfig, imgs: Optional[Sequence[np.ndarray]] = None,
              device="cuda", mesh_devices=None) -> np.ndarray:
    """2-phase batch pipeline (reference BatchSim, Deff2D.cuh:1843).

    ``mesh_devices``: the devices ``Devices:``/``DP:``/``SP:`` lay their
    mesh on (default: every visible CUDA device; a device may repeat).

    Returns the (NumImg, 9) output table:
    imgNum, porosity, PathFlag, Deff, Time, nElements, converge, ds, df.
    """
    cfg.validate()
    resolve_device(device)
    if imgs is None:
        imgs = img_io.load_batch(cfg.num_images, cfg.image_dir)
    n = len(imgs)
    out = np.zeros((n, 9))

    inc = writers.IncrementalBatchWriter(cfg.output_name) if cfg.incremental_output else None
    done = inc.completed() if inc else set()
    pending = [i for i in range(n) if i not in done]
    if done:
        vprint(cfg.verbose, f"Resuming batch: {len(done)} images already completed")

    groups = _group_by_shape(imgs, pending, cfg.batch_size)

    def prepare(group):
        stack = np.stack([imgs[i] for i in group])
        stats = [(phases.porosity(imgs[i]),
                  floodfill.flood_fill(imgs[i] > 150).path_flag) for i in group]
        return stack, stats

    for group, (stack, stats) in _prefetched(groups, prepare):
        deff, conv, iters, _, dt = solve_image_group(cfg, stack, device,
                                                     mesh_devices)
        times = _attribute_time(dt, iters)
        for k, i in enumerate(group):
            im = imgs[i]
            poro, pf = stats[k]
            ne = im.shape[0] * cfg.mesh_amp_y * im.shape[1] * cfg.mesh_amp_x
            row = (i, poro, int(pf), float(deff[k]), float(times[k]),
                   ne, float(conv[k]), cfg.d_solid, cfg.d_fluid)
            out[i] = row
            if inc:
                inc.write_row(row)
            vprint(cfg.verbose, f"Number {i} DCF = {cfg.d_fluid}, Deff {float(deff[k])}")

    if not cfg.incremental_output:
        writers.write_batch(cfg.output_name, [tuple(r) for r in out])
    return out


def batch_sim_3phase(cfg: SimulationConfig, imgs: Optional[Sequence[np.ndarray]] = None,
                     device="cuda", mesh_devices=None) -> np.ndarray:
    """3-phase batch pipeline (reference BatchSim3Phase, Deff2D.cuh:2056);
    ``mesh_devices`` as for :func:`batch_sim`.

    Returns the (NumImg, 11) output table:
    imgNum, SVF, LVF, PathFlag, Deff, Time, nElements, converge, ds, df, dg.
    """
    cfg.validate()
    resolve_device(device)
    if imgs is None:
        imgs = img_io.load_batch(cfg.num_images, cfg.image_dir)
    n = len(imgs)
    out = np.zeros((n, 11))

    inc = (writers.IncrementalBatchWriter(cfg.output_name, three_phase=True)
           if cfg.incremental_output else None)
    done = inc.completed() if inc else set()
    pending = [i for i in range(n) if i not in done]

    groups = _group_by_shape(imgs, pending, cfg.batch_size)

    def prepare(group):
        stack = np.stack([imgs[i] for i in group])
        flags = [floodfill.flood_fill(imgs[i] > 200).path_flag for i in group]
        return stack, flags

    for group, (stack, flags) in _prefetched(groups, prepare):
        deff, conv, iters, x, dt, svf, lvf = solve_image_group_3phase(
            cfg, stack, device, mesh_devices)
        times = _attribute_time(dt, iters)
        for k, i in enumerate(group):
            im = imgs[i]
            ne = im.shape[0] * cfg.mesh_amp_y * im.shape[1] * cfg.mesh_amp_x
            row = (i, float(svf[k]), float(lvf[k]), int(flags[k]),
                   float(deff[k]), float(times[k]), ne, float(conv[k]),
                   cfg.d_solid, cfg.d_fluid, cfg.d_gas)
            out[i] = row
            if inc:
                inc.write_row(row)
            if cfg.print_cmap:
                writers.write_cmap(f"CMAP_{i:05d}.csv", x[k])

    if not cfg.incremental_output:
        writers.write_batch_3phase(cfg.output_name, [tuple(r) for r in out])
    return out
