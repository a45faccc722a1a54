"""Component-deflated PCG for extreme-contrast multiphase systems (torch
port of ``effectivediffusivityfvm_tpu.solvers.deflation``; solver ``dcg``).

With Dg ~ 1e6 every connected gas component behaves as a near-equipotential
super-node, so the operator has one near-kernel vector per component and
kappa ~ contrast x n^2.  The coarse space of the two-level method is exactly
those components:

  W   = indicator vectors of the connected high-D components
        (disjoint supports: W^T v is a segment sum, W y is a gather)
  E   = W^T A W, assembled on the host from the face conductances that
        cross between components
  and deflated PCG in projection form (Tang & Vuik):
      Q = W E^-1 W^T,   P v = v - A Q v
      iterate CG on P A with diagonal preconditioning; recover
      x = Q b + (I - Q A) x_hat.

The coarse apply (:func:`_coarse_apply`) sums each component's cells and
gathers the coarse solution back to them.  The sum must not depend on the
run: the deflated iteration amplifies rounding by ``||Q|| ~ 1e6``.  So the
labelled cells are ordered by label once per solve (:class:`Segments`),
summed in fixed-size rows and each component's run of rows summed by
``torch.segment_reduce`` -- no atomics; the gather indexes the coarse
vector extended by one zero, which the unlabelled cells read.

Registered as solver ``dcg``; with no components it falls back to plain
diagonal PCG (:mod:`.cg`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import fvm
from ..ops.flux import boundary_deff
from .driver import SolveResult, resolve_check_every

__all__ = ["DeflationSpace", "Segments", "label_components",
           "build_component_deflation", "run_deflated_pcg", "solve_dcg",
           "solve_dcg_batched"]


class DeflationSpace(NamedTuple):
    """Component coarse space with the inverse held in Jacobi-scaled
    FACTORED form: ``E = D^1/2 Ehat D^1/2`` and the apply is
    ``y = D^-1/2 (Ehat^-1 (D^-1/2 rc))`` (a premultiplied dense ``E^-1``
    would span kappa(E) decades and floor the deflated solves).

    Single image: ``labels`` ``(ny, nx)``, ``e_hat_inv`` ``(m, m)``,
    ``dhalf_inv`` ``(m,)``; a padded batch: ``(B, ny, nx)``, ``(B, m, m)``,
    ``(B, m)``."""

    labels: torch.Tensor     # int; -1 = not in any component
    e_hat_inv: torch.Tensor  # inverse of the unit-diagonal Ehat
    dhalf_inv: torch.Tensor  # 1/sqrt(diag(E))
    m: int                   # number of components


def label_components(member: np.ndarray, periodic_y: bool = True) -> np.ndarray:
    """Connected 4-components of a boolean mask, periodic in Y (matching the
    flood-fill convention, Deff2D.cuh:640-671).  Returns int labels, -1
    outside, 0..m-1 inside (canonical)."""
    from scipy import ndimage

    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)
    lbl, num = ndimage.label(member, structure=structure)
    if num and periodic_y:
        parent = np.arange(num + 1)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        top, bot = lbl[0, :], lbl[-1, :]
        both = (top > 0) & (bot > 0)
        for a, b in zip(top[both], bot[both]):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[rb] = ra
        roots = np.array([find(int(i)) for i in range(num + 1)])
        # compact to 0..m-1
        uniq = np.unique(roots[1:]) if num else np.array([], int)
        remap = np.full(num + 1, 0)
        remap[uniq] = np.arange(1, len(uniq) + 1)
        lbl = remap[roots[lbl]]
    return lbl.astype(np.int64) - 1


def _assemble_e_host(coeffs: fvm.StencilCoeffs, labels: np.ndarray,
                     m: int) -> np.ndarray:
    """E = W^T A W on the host (fetches the a_e, a_s and diag planes)."""
    a_e = coeffs.a_e.detach().cpu().numpy().astype(np.float64)
    a_s = coeffs.a_s.detach().cpu().numpy().astype(np.float64)
    diag = coeffs.diag.detach().cpu().numpy().astype(np.float64)

    E = np.zeros((m, m))
    # the component's diagonal entries first; each face (p, q) with
    # conductance a then adds -a at (lp, lq) and (lq, lp), which takes 2a
    # off the diagonal for a face inside one component
    sel = labels >= 0
    np.add.at(E, (labels[sel], labels[sel]), diag[sel])

    def add_faces(a_face, lp, lq):
        ok = (lp >= 0) & (lq >= 0) & (a_face != 0)
        np.add.at(E, (lp[ok], lq[ok]), -a_face[ok])
        np.add.at(E, (lq[ok], lp[ok]), -a_face[ok])

    # x faces: between (i, j) and (i, j+1): conductance a_e[i, j]
    add_faces(a_e[:, :-1], labels[:, :-1], labels[:, 1:])
    # y faces: between (i, j) and (i+1, j): conductance a_s[i, j]
    add_faces(a_s[:-1, :], labels[:-1, :], labels[1:, :])
    return E


def build_component_deflation(coeffs: fvm.StencilCoeffs,
                              member: np.ndarray,
                              periodic_y: bool = False,
                              jitter: float = 1e-12,
                              ) -> Optional[DeflationSpace]:
    """Assemble the coarse space over the connected components of ``member``
    (typically the gas phase) of one image.  O(N) host preprocessing;
    returns None when there are no components.

    ``periodic_y`` defaults to False: the coarse space follows the
    OPERATOR's topology (no-flux y boundaries), not the flood fill's
    periodic convention.  Components with (numerically) zero external
    conductance -- equipotential islands that cannot affect any flux -- are
    dropped, since their singular E rows would poison the inverse.
    """
    labels = label_components(np.asarray(member, bool), periodic_y)
    m = int(labels.max()) + 1
    if m <= 0:
        return None
    return factored_space(_assemble_e_host(coeffs, labels, m), labels,
                          jitter, coeffs.diag.device, coeffs.diag.dtype)


def factored_space(E: np.ndarray, labels: np.ndarray, jitter: float,
                   device, dtype) -> Optional[DeflationSpace]:
    """The :class:`DeflationSpace` of the coarse matrix ``E`` over the
    components ``labels`` (2D or 3D): the components with (numerically)
    zero external conductance -- equipotential islands that cannot affect
    any flux -- dropped, since their singular E rows would poison the
    inverse; a relative ``jitter`` on the diagonal; the inverse held in
    Jacobi-scaled factored form.  ``None`` when no component is kept."""
    m = E.shape[0]
    row_ext = E.sum(axis=1)
    keep = row_ext > 1e-10 * max(np.max(np.abs(row_ext)), 1e-300)
    if not np.any(keep):
        return None
    if not np.all(keep):
        old_to_new = np.full(m, -1)
        old_to_new[keep] = np.arange(int(keep.sum()))
        remap = np.concatenate([old_to_new, [-1]])   # labels == -1 stay -1
        labels = remap[labels]
        E = E[np.ix_(keep, keep)]
        m = int(keep.sum())

    E = E + jitter * np.trace(E) / m * np.eye(m)
    dhalf = np.sqrt(np.diag(E))
    e_hat = E / dhalf[:, None] / dhalf[None, :]
    return DeflationSpace(
        labels=torch.as_tensor(labels.astype(np.int32), device=device),
        e_hat_inv=torch.as_tensor(np.linalg.inv(e_hat), dtype=dtype,
                                  device=device),
        dhalf_inv=torch.as_tensor(1.0 / dhalf, dtype=dtype, device=device),
        m=m,
    )


class Segments:
    """The labelled cells of a deflation space ordered by component, built
    once per solve.

    ``W^T r`` sums each component's cells in two fixed-shape levels: the
    cells, component by component, fill rows of ``CHUNK`` indices
    (``table``; a component's last row padded with the index of a zero
    appended to the field), each row is summed, and each component's run
    of rows (``rows``, rows a component; the batch's components in image
    order) is summed by ``torch.segment_reduce``.  No atomics, so the same
    sum every run; and no long sequential run in one thread, which a
    component of ~1e5 cells would give ``segment_reduce`` on the cells
    themselves.  ``gather``: each cell's index into the coarse vector
    extended by one zero, which the unlabelled cells read."""

    CHUNK = 1024

    def __init__(self, defl: DeflationSpace):
        lab = defl.labels.detach().cpu().numpy().astype(np.int64)
        nb = lab.shape[0] if defl.e_hat_inv.dim() == 3 else 1
        flat = lab.reshape(nb, -1)
        n = flat.size
        seg = np.where(flat >= 0, flat + defl.m * np.arange(nb)[:, None], -1)
        seg = seg.reshape(-1)
        cells = np.flatnonzero(seg >= 0)
        perm = cells[np.argsort(seg[cells], kind="stable")]
        length = np.bincount(seg[cells], minlength=nb * defl.m)
        rows = -(-length // self.CHUNK)
        # each ordered cell's place: its component's first row, then
        # row-major within the component's rows
        pos = np.arange(perm.size) - np.repeat(np.cumsum(length) - length,
                                               length)
        first = np.cumsum(rows) - rows
        table = np.full((int(rows.sum()), self.CHUNK), n, np.int64)
        table[np.repeat(first, length) + pos // self.CHUNK,
              pos % self.CHUNK] = perm
        dev = defl.labels.device
        self.table = torch.as_tensor(table, device=dev)
        self.rows = torch.as_tensor(rows, device=dev)
        self.gather = torch.as_tensor(
            np.where(seg >= 0, seg, nb * defl.m), device=dev)


def _coarse_apply(defl: DeflationSpace, r: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  seg: Optional[Segments] = None) -> torch.Tensor:
    """``W E^-1 W^T r``: ``W^T r`` a segment sum over each component's cells
    in label order (:class:`Segments`), ``W y`` a gather of ``y[labels]``
    (0 outside every component); the same result on every run.

    ``weight`` generalizes the space to per-cell-scaled indicators
    ``W' = diag(weight) W`` (still disjoint supports).  The equilibrated
    engine (``dmg``) passes ``weight = 1/s = sqrt(diag)``, for which
    ``E' = W'^T A' W' = E``.  ``seg``: the space's :class:`Segments`, kept
    by a caller that applies it again and again (else built here).
    """
    seg = Segments(defl) if seg is None else seg
    rr = r * weight if weight is not None else r
    flat = torch.cat([rr.reshape(-1), rr.new_zeros(1)])
    rc = torch.segment_reduce(flat[seg.table].sum(dim=1), "sum",
                              lengths=seg.rows, unsafe=True)
    rc = rc.reshape(defl.dhalf_inv.shape)
    dhi = defl.dhalf_inv.to(r.dtype)
    y = dhi * (defl.e_hat_inv.to(r.dtype) @ (dhi * rc)[..., None])[..., 0]
    y = torch.cat([y.reshape(-1), y.new_zeros(1)])
    out = y[seg.gather].reshape(r.shape)
    return out * weight if weight is not None else out


def run_deflated_pcg(coeffs, b, x0, defl: Optional[DeflationSpace], precond,
                     *, tol, max_iter, check_every, weight=None):
    """Projected deflated-PCG engine (Tang & Vuik DEF form).

    ``precond(r)`` is any SPD preconditioner application (diagonal for
    ``dcg``); ``defl=None`` degenerates to plain preconditioned CG.  Every
    window (1, then ``check_every`` iterations, the last cut at
    ``max_iter``) ends with a check: the true relative residual of the
    *recovered* solution, a best-iterate snapshot, a divergence net
    (non-finite or 1e3x the best) and a restart on the true projected
    residual.  Returns ``(x, rel, iters)``.

    ``(B, ny, nx)`` systems with a padded batch space run as one batch in
    which an image whose own loop would have stopped keeps its whole state
    (as the JAX package's vmapped while_loop keeps it).  The host reads the
    stop flags once a window.
    """
    dtype, dev = x0.dtype, x0.device
    tol_ = torch.tensor(tol, dtype=dtype, device=dev)
    check_every = resolve_check_every(check_every, 100)
    axes = (-2, -1)
    bshape = x0.shape[:-2]

    def matvec(p):
        return fvm.apply_operator(coeffs, p)

    if defl is not None:
        seg = Segments(defl)

        def q_apply(v):
            return _coarse_apply(defl, v, weight, seg)
    else:
        def q_apply(v):
            return torch.zeros_like(v)

    def p_apply(v):
        # P v = v - A Q v
        return v - matvec(q_apply(v))

    def recover(xh):
        # x = Q b + (I - Q A) x_hat
        return q_apply(b) + xh - q_apply(matvec(xh))

    def dot(u, v):
        return torch.sum(u * v, dim=axes)

    def expand(v):
        return v[..., None, None]

    bscale = torch.mean(torch.abs(b), dim=axes)

    def true_rel(xh):
        return torch.mean(torch.abs(b - matvec(recover(xh))), dim=axes) / bscale

    def cg_iter(xh, r, p, rz):
        q = p_apply(matvec(p))            # P A p
        pq = dot(p, q)
        alpha = torch.where(pq > 0, rz / torch.where(pq > 0, pq, 1.0), 0.0)
        xh = xh + expand(alpha) * p
        r = r - expand(alpha) * q
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = z + expand(beta) * p
        return xh, r, p, rz_new

    def fresh(xh):
        r = p_apply(b - matvec(recover(xh)))
        z = precond(r)
        return r, z, dot(r, z)

    xh = x0
    r, p, rz = fresh(x0)
    pc = torch.full(bshape, 100.0, dtype=dtype, device=dev)
    best = true_rel(x0)
    xh_best = x0
    its = torch.zeros(bshape, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iter:
        live = tol_ < torch.abs(pc)
        if not bool(live.any()):
            break
        k = 1 if it == 0 else min(check_every, max_iter - it)
        s = (xh, r, p, rz)
        for _ in range(k):
            s = cg_iter(*s)
        it += k
        xh_n = s[0]
        rel = true_rel(xh_n)
        improved = rel < best
        xh_best_n = torch.where(expand(improved), xh_n, xh_best)
        best_n = torch.where(improved, rel, best)
        diverged = ~torch.isfinite(rel) | (rel > 1e3 * best_n)
        # restart the recurrence on the true projected residual
        r_n, z_n, rz_n = fresh(xh_n)
        # an image whose loop has stopped keeps its state (in single mode
        # the loop has left before then)
        lv = expand(live)
        xh = torch.where(lv, xh_n, xh)
        r = torch.where(lv, r_n, r)
        p = torch.where(lv, r_n * 0 + z_n, p)
        rz = torch.where(live, rz_n, rz)
        pc = torch.where(live, torch.where(diverged, 0.0, rel), pc)
        best = torch.where(live, best_n, best)
        xh_best = torch.where(lv, xh_best_n, xh_best)
        its = its + torch.where(live, k, 0).to(torch.int32)
    return recover(xh_best), best, its


def _solve_dcg_core(coeffs, spec, x0, defl, *, tol, max_iter, check_every):
    x, best, iters = run_deflated_pcg(
        coeffs, coeffs.b, x0, defl, lambda r: coeffs.diag_inv * r,
        tol=tol, max_iter=max_iter, check_every=check_every)
    return SolveResult(x=x, deff=boundary_deff(spec, x), conv=best,
                       iters=iters)


def solve_dcg(coeffs, spec, x0, *, omega: float = 0.0, tol: float = 1e-8,
              max_iter: int = 100_000, check_every: int = 0,
              criterion: str = "relresidual",
              member: Optional[np.ndarray] = None,
              defl: Optional[DeflationSpace] = None) -> SolveResult:
    """Deflated PCG.  Pass either a prebuilt :class:`DeflationSpace` or the
    boolean ``member`` mask of the high-D phase (host array); with neither,
    falls back to plain diagonal PCG.  The deflated engine always stops on
    the relative residual; ``omega`` and ``criterion`` reach only the
    fallback."""
    if defl is None and member is not None:
        defl = build_component_deflation(coeffs, member)
    if defl is None:
        from .cg import solve_cg

        return solve_cg(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                        check_every=check_every, criterion=criterion)
    return _solve_dcg_core(coeffs, spec, x0, defl, tol=tol,
                           max_iter=max_iter, check_every=check_every)


def _pad_deflation(defl: Optional[DeflationSpace], shape, dtype,
                   m_max: int) -> tuple:
    """Pad one image's deflation space to the batch-wide component count.

    Zero-padded Ehat^-1/scale rows are inert: no cell carries a padded
    label, so their segment sums are zero and the gather never reads them.
    An image with no components (labels all -1, factors all zero)
    degenerates to plain diagonal PCG inside the same batched solve.
    Returns numpy ``(labels, e_hat_inv, dhalf_inv)``.
    """
    if defl is None:
        return (np.full(shape, -1, np.int32),
                np.zeros((m_max, m_max), dtype), np.zeros((m_max,), dtype))
    lab = defl.labels.cpu().numpy().astype(np.int32)
    e = np.zeros((m_max, m_max), dtype)
    e[:defl.m, :defl.m] = defl.e_hat_inv.cpu().numpy()
    dh = np.zeros((m_max,), dtype)
    dh[:defl.m] = defl.dhalf_inv.cpu().numpy()
    return lab, e, dh


def batch_space(defls, shape, dtype, device) -> Optional[DeflationSpace]:
    """The batch's spaces padded to the largest component count and stacked
    (``None`` when no image has a component)."""
    m_max = max((d.m for d in defls if d is not None), default=0)
    if m_max == 0:
        return None
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    padded = [_pad_deflation(d, shape, np_dtype, m_max) for d in defls]
    return DeflationSpace(
        *(torch.as_tensor(np.stack([p[i] for p in padded]), device=device)
          for i in range(3)), m=m_max)


def batch_defls(coeffs, members):
    """One deflation space per image of a batch, from ``members[k]``."""
    return [build_component_deflation(
        fvm.StencilCoeffs(*(a[k] for a in coeffs)), np.asarray(members[k]))
        for k in range(coeffs.b.shape[0])]


def solve_dcg_batched(coeffs, spec, x0, *, omega: float = 0.0,
                      tol: float = 1e-8, max_iter: int = 100_000,
                      check_every: int = 0, criterion: str = "relresidual",
                      members: Optional[np.ndarray] = None,
                      defls: Optional[list] = None) -> SolveResult:
    """Batched deflated PCG with per-image deflation spaces.

    Each image gets its own component coarse space (built on the host from
    ``members[b]``, or passed prebuilt as ``defls``), zero-padded to the
    batch-wide maximum component count; the batch then advances as one
    solve in which an image that meets its tolerance keeps its state, so
    results match solo runs at the same check schedule.
    """
    if defls is None and members is not None:
        defls = batch_defls(coeffs, members)
    space = (None if defls is None
             else batch_space(defls, x0.shape[1:], x0.dtype, x0.device))
    if space is None:
        from .cg import solve_cg_batched

        return solve_cg_batched(coeffs, spec, x0, tol=tol, max_iter=max_iter,
                                check_every=check_every, criterion=criterion)
    return _solve_dcg_core(coeffs, spec, x0, space, tol=tol,
                           max_iter=max_iter, check_every=check_every)
