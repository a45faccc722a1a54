"""kappa-robust deflated MGCG on voxel volumes: the 3D mirror of
:mod:`.dmg` (torch port of ``effectivediffusivityfvm_tpu.solvers.dmg3d``;
solver ``dmg`` on a ``(nz, ny, nx)`` volume).

The numerics are the 2D solver's: gas-component indicator deflation in the
A-DEF2 two-apply form on the symmetric-equilibrated system, the V-cycle
built on the RAW operator and applied through the similarity maps, the
Krylov iteration in f64 with the cycle in f32.  The coarse apply
(:class:`~.deflation.Segments`) is dimension-agnostic; the labelling
(6-connected, not periodic), the assembly of ``E = W^T A W`` and the
cycle are 3D.

The V-cycle is K6: its whole cycle
(:func:`~..ops.kernels.vcycle3d.v_cycle3d`) on the even-padded hierarchy
(:func:`_dmg3d_engine_auto`, at every size and ``nu`` K6 takes), or,
forced, its banded cycle (:func:`~..ops.kernels.vcycle3d.v_cycle3d_tiled`)
on :func:`~.solvers3d.tiled3d_system`'s; for a ``nu`` past K6's, or with
``use_pallas=False``, the plain torch :func:`~.solvers3d.v_cycle_3d` on
the unpadded hierarchy, which is the JAX package's own cycle here (its
XLA ``v_cycle_3d``).  No cycle takes a per-volume flag, so in a batch a
converged volume's cycle is computed and discarded.  ``plain=True`` runs
the kernels' plain versions (for comparisons on the card); on a CPU tensor
the wrappers run them anyway.  Needs f64 inputs (``Dtype: float64``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fvm3d
from ..ops.fvm import decouple_empty_rows
from ..ops.fvm3d import StencilCoeffs3D, boundary_deff_3d
from ..ops.kernels.vcycle3d import (HALO_Z, MAX_NU3, Level3Args, v_cycle3d,
                                    v_cycle3d_reference, v_cycle3d_tiled,
                                    v_cycle3d_tiled_reference)
from .deflation import (DeflationSpace, Segments, _coarse_apply, batch_space,
                        factored_space)
from .dmg import _check_f64
from .driver import SolveResult, resolve_check_every
from .pcg import run_pcg
from .solvers3d import build_hierarchy_3d, tiled3d_system, v_cycle_3d

__all__ = ["label_components_3d", "build_component_deflation_3d",
           "solve_dmg_3d", "solve_dmg_3d_batched"]


def label_components_3d(member: np.ndarray) -> np.ndarray:
    """6-connected components of a boolean voxel mask, NOT periodic: the
    coarse space follows the operator's no-flux y/z boundaries, not the
    flood fill's periodic convention.  Returns int labels, -1 outside."""
    from scipy import ndimage

    structure = ndimage.generate_binary_structure(3, 1)
    lbl, _ = ndimage.label(member, structure=structure)
    return lbl.astype(np.int64) - 1


def _assemble_e_host_3d(coeffs: StencilCoeffs3D, labels: np.ndarray,
                        m: int) -> np.ndarray:
    """``E = W^T A W`` on the host from the diagonal and the x, y and z
    face conductances (``a_e``, ``a_s``, ``a_d``) of a symmetric volume
    operator."""
    def host(a):
        return a.detach().cpu().numpy().astype(np.float64)

    a_e, a_s, a_d, diag = (host(coeffs.a_e), host(coeffs.a_s),
                           host(coeffs.a_d), host(coeffs.diag))
    E = np.zeros((m, m))
    sel = labels >= 0
    np.add.at(E, (labels[sel], labels[sel]), diag[sel])

    def add_faces(a_face, lp, lq):
        ok = (lp >= 0) & (lq >= 0) & (a_face != 0)
        np.add.at(E, (lp[ok], lq[ok]), -a_face[ok])
        np.add.at(E, (lq[ok], lp[ok]), -a_face[ok])

    add_faces(a_e[..., :-1], labels[..., :-1], labels[..., 1:])
    add_faces(a_s[:, :-1, :], labels[:, :-1, :], labels[:, 1:, :])
    add_faces(a_d[:-1], labels[:-1], labels[1:])
    return E


def build_component_deflation_3d(coeffs: StencilCoeffs3D, member: np.ndarray,
                                 jitter: float = 1e-12,
                                 ) -> Optional[DeflationSpace]:
    """The gas-component coarse space of one volume (the 2D builder's
    ``keep`` filter, jitter and factored inverse); ``None`` without a
    component."""
    labels = label_components_3d(np.asarray(member, bool))
    m = int(labels.max()) + 1
    if m <= 0:
        return None
    return factored_space(_assemble_e_host_3d(coeffs, labels, m), labels,
                          jitter, coeffs.diag.device, coeffs.diag.dtype)


def _nu_ok(nu):
    return 1 <= nu <= min(MAX_NU3, HALO_Z - 1)


def _dmg3d_engine_auto(shape, dtype, nu):
    """The cycle for a ``(.., nz, ny, nx)`` solve whose V-cycle runs in
    ``dtype``: ``True``, K6's whole cycle, at every shape and dtype for a
    ``nu`` in K6's ``1..MAX_NU3``, else ``False``, the plain torch cycle.
    On an H100 one whole cycle of this solve was faster than the banded
    one, or within 1% of it, at every size and batch measured (16^3 to
    256^3, B=1 and 8: ``chip_smoke.py``'s phase 36), and the two give the
    same iterates.  ``use_pallas="tiled3d"`` still forces the banded
    cycle."""
    del shape, dtype            # neither moves the choice on the card
    return _nu_ok(nu)


def _resolve_engine(use_pallas, shape, dtype, nu):
    if use_pallas is None:
        return _dmg3d_engine_auto(shape, dtype, nu)
    if use_pallas is False:
        return False
    if use_pallas is True or use_pallas == "tiled3d":
        if not _nu_ok(nu):
            raise ValueError(f"K6 takes 1 <= nu <= {MAX_NU3}, got nu={nu}")
        return use_pallas
    raise ValueError(f"unknown use_pallas {use_pallas!r}")


def _cycle3(raw: StencilCoeffs3D, engine, *, nu, mg_omega, coarse_iters,
            min_size, over, plain):
    """``cycle(rr)`` on ``(B, nz, ny, nx)`` residuals in the cycle dtype,
    with the hierarchy of ``raw`` and the kernel's level tables built once.

    K6 whole (``True``): the even-padded hierarchy, ``r`` padded to level
    0.  K6 banded (``"tiled3d"``): the operator padded to ``pad_shape_3d``,
    levels as the 3D MGCG engine builds them.  ``False``:
    :func:`~.solvers3d.v_cycle_3d`, V(nu, nu), on ``build_hierarchy_3d(raw)``
    unpadded, as the JAX package builds it."""
    bsz, nz, ny, nx = raw.b.shape
    if engine is False:
        levels = build_hierarchy_3d(raw, min_size=min_size)

        def plain_cycle(rr):
            return v_cycle_3d(levels, rr, nu1=nu, nu2=nu, omega=mg_omega,
                              coarse_iters=coarse_iters, over=over)
        return plain_cycle
    kw = dict(omega=mg_omega, nu=nu, coarse_iters=coarse_iters, over=over)
    on_card = not plain and raw.b.is_cuda
    if engine == "tiled3d":
        levels, _ = tiled3d_system(raw, min_size=min_size)
        fn = v_cycle3d_tiled_reference if plain else v_cycle3d_tiled
        if on_card:
            kw["tail_args"] = Level3Args(levels[1:], levels[1].b)
    else:
        levels = build_hierarchy_3d(raw, min_size=min_size, pad_levels=True)
        fn = v_cycle3d_reference if plain else v_cycle3d
        if on_card:
            kw["level_args"] = Level3Args(levels, levels[0].b)
    pz, py, px = levels[0].diag.shape[-3:]

    def cycle(rr):
        rp = F.pad(rr, (0, px - nx, 0, py - ny, 0, pz - nz))
        return fn(levels, rp.contiguous(), **kw)[..., :nz, :ny, :nx]
    return cycle


def _solve_dmg3d_core(coeffs, spec, x0, defl: Optional[DeflationSpace], *,
                      batched, tol, max_iter, check_every, criterion, engine,
                      precond_f32, plain, nu, mg_omega, coarse_iters,
                      min_size, over) -> SolveResult:
    """JAX ``_solve_dmg_3d_jit`` term for term, on K6's cycle or the
    plain one."""
    dtype = x0.dtype
    coeffs = decouple_empty_rows(coeffs)
    c_eq, s = fvm3d.equilibrate_3d(coeffs)
    w = 1.0 / s

    pdt = torch.float32 if precond_f32 else dtype
    raw = StencilCoeffs3D(*(a.to(pdt) for a in coeffs))
    if not batched:
        raw = StencilCoeffs3D(*(a[None] for a in raw))
    cycle = _cycle3(raw, engine, nu=nu, mg_omega=mg_omega,
                    coarse_iters=coarse_iters, min_size=min_size, over=over,
                    plain=plain)

    def matvec(p):
        return fvm3d.apply_operator_3d(c_eq, p)

    if defl is not None:
        seg = Segments(defl)

        def q_apply(v):
            return _coarse_apply(defl, v, w, seg)

    def precond(r, active=None):
        del active      # K6 takes no per-volume flag
        rr = (w * r).to(pdt)
        zc = cycle(rr) if batched else cycle(rr[None])[0]
        z = w * zc.to(dtype)
        if defl is None:
            return z
        # A-DEF2 two-apply form, NOT folded (see dmg.py)
        return z - q_apply(matvec(z)) + q_apply(r)

    x0e = x0 / s
    x0h = (x0e if defl is None
           else q_apply(c_eq.b) + x0e - q_apply(matvec(x0e)))
    res = run_pcg(
        matvec=matvec, precond=precond, b=c_eq.b, x0=x0h,
        deff_fn=lambda xh: boundary_deff_3d(spec, s * xh),
        tol=tol, max_iter=max_iter,
        check_every=resolve_check_every(check_every, 10),
        criterion=criterion, grid_ndim=3, batched=batched,
    )
    return res._replace(x=s * res.x)


def _mg_kw(nu, mg_omega, coarse_iters, min_size, over):
    return dict(nu=nu, mg_omega=mg_omega, coarse_iters=coarse_iters,
                min_size=min_size, over=over)


def solve_dmg_3d(coeffs, spec, x0, *, omega: float = 0.0, tol: float = 1e-10,
                 max_iter: int = 2_000, check_every: int = 0,
                 criterion: str = "relresidual",
                 member: Optional[np.ndarray] = None,
                 defl: Optional[DeflationSpace] = None,
                 precond_f32: bool = True, nu: int = 2, mg_omega: float = 0.8,
                 coarse_iters: int = 32, min_size: int = 4,
                 over: float = 1.8, use_pallas=None,
                 plain: bool = False) -> SolveResult:
    """Deflated multigrid-PCG on one ``(nz, ny, nx)`` volume, f64 in and
    out.  ``use_pallas``: None = :func:`_dmg3d_engine_auto`, True = K6's
    whole cycle, ``"tiled3d"`` = its banded cycle, False = the plain torch
    cycle;
    ``plain=True`` runs the cycle's plain version.  ``omega`` is signature
    parity."""
    del omega
    _check_f64(x0, "solve_dmg_3d")
    if defl is None and member is not None:
        defl = build_component_deflation_3d(coeffs, member)
    engine = _resolve_engine(use_pallas, x0.shape,
                             torch.float32 if precond_f32 else x0.dtype, nu)
    return _solve_dmg3d_core(
        coeffs, spec, x0, defl, batched=False, tol=tol, max_iter=max_iter,
        check_every=check_every, criterion=criterion, engine=engine,
        precond_f32=precond_f32, plain=plain,
        **_mg_kw(nu, mg_omega, coarse_iters, min_size, over))


def solve_dmg_3d_batched(coeffs, spec, x0, *, omega: float = 0.0,
                         tol: float = 1e-10, max_iter: int = 2_000,
                         check_every: int = 0,
                         criterion: str = "relresidual",
                         members: Optional[np.ndarray] = None,
                         defls: Optional[list] = None,
                         precond_f32: bool = True, nu: int = 2,
                         mg_omega: float = 0.8, coarse_iters: int = 32,
                         min_size: int = 4, over: float = 1.8,
                         use_pallas=None, plain: bool = False) -> SolveResult:
    """Batched 3D deflated MGCG on ``(B, nz, ny, nx)``: per-volume
    deflation spaces zero-padded to the batch-wide maximum component count
    (a component-free volume degenerates to plain MGCG in the same batch),
    one batched PCG loop in which a converged volume is frozen.  The JAX
    package vmaps its single solve; each volume's result agrees with its
    solo run at the same check schedule."""
    del omega
    _check_f64(x0, "solve_dmg_3d_batched")
    if defls is None and members is not None:
        defls = [build_component_deflation_3d(
            StencilCoeffs3D(*(a[k] for a in coeffs)), np.asarray(members[k]))
            for k in range(x0.shape[0])]
    space = (None if defls is None
             else batch_space(defls, x0.shape[1:], x0.dtype, x0.device))
    engine = _resolve_engine(use_pallas, x0.shape,
                             torch.float32 if precond_f32 else x0.dtype, nu)
    return _solve_dmg3d_core(
        coeffs, spec, x0, space, batched=True, tol=tol, max_iter=max_iter,
        check_every=check_every, criterion=criterion, engine=engine,
        precond_f32=precond_f32, plain=plain,
        **_mg_kw(nu, mg_omega, coarse_iters, min_size, over))
