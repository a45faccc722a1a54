"""Entry ``mgcg_batched``: a request is one batch of device-resident
diffusivity fields through the port's assembly
(``ops/fvm.py::fvm_coefficients``, ``ops/flux.py::make_flux_spec``) and
``solvers/multigrid.py::solve_mgcg_batched`` (the fused engine the
configuration names: K1's windows around K2's cycle), ending with every
image's Deff on the host.

Traffic keys: ``batch`` (images a request), ``size`` (pixels a side),
``pool_batches`` (distinct batches made at set-up, taken round-robin).

The output check judges each sampled solve by what it says: its field
``x`` must meet the configuration's stopping rule, ``mean |b - A x| <=
tol``, in the reference's own float64 system built again from the image
(the configuration's own limit), and its Deff must be eq. 6 of that field
to float64's rounding.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import gen
from ..control import PROGRAM_DTYPES, lower_dtype
from ..reference import fvm2d, jacobi
from ..sample import Reservoir
from ..trace import span
from ..work import hierarchy_cells

# the damping of the reference's sweeps where they stand in for the solve
REFERENCE_OMEGA = 2.0 / 3.0


def solver_kwargs(solver: dict) -> dict:
    kw = {k: solver[k] for k in ("tol", "max_iter", "check_every",
                                 "criterion", "first_window", "min_size",
                                 "coarse_iters", "nu1", "nu2", "over")}
    kw["mg_omega"] = tuple(solver["mg_omega"])
    kw["use_pallas"] = solver["engine"]
    return kw


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 traced: bool = False):
        from effectivediffusivityfvm_tpu_torch.ops import fvm, flux
        from effectivediffusivityfvm_tpu_torch.solvers import multigrid

        self.fvm, self.flux, self.multigrid = fvm, flux, multigrid
        self.cfg, self.dev, self.traced = config, torch.device(device), traced
        self.batch, self.size = traffic["batch"], traffic["size"]
        self.per_request = self.batch
        self.pool = traffic["pool_batches"]
        med = config["medium"]
        self.solid = gen.solid_masks(
            gen.generator(seed, self.dev), self.batch * self.pool, self.size,
            sigma=med["sigma"], porosity=med["porosity"]).view(
                self.pool, self.batch, self.size, self.size)
        self.dtype = getattr(torch, config["dtype"])
        one = torch.ones((), dtype=self.dtype, device=self.dev)
        self.fields = [torch.where(s, config["d_solid"] * one,
                                   config["d_fluid"] * one)
                       for s in self.solid]
        self.kw = solver_kwargs(config["solver"])
        row = torch.arange(self.size, dtype=self.dtype, device=self.dev)
        self.x0 = (row / self.size * (config["c_right"] - config["c_left"])
                   + config["c_left"]).expand(self.batch, self.size,
                                              self.size)
        self.kept = Reservoir(config["check"]["sample"],
                              gen.host_rng(seed, 1))
        self.sync = (torch.cuda.synchronize if self.dev.type == "cuda"
                     else lambda: None)

    def _solve(self, k: int):
        d = self.fields[gen.round_robin(k, self.pool)]
        cl, cr = self.cfg["c_left"], self.cfg["c_right"]
        t = 0.0
        with span("assembly"):
            if self.traced:
                self.sync()
                t = time.perf_counter()
            coeffs = self.fvm.fvm_coefficients(d, cl, cr)
            spec = self.flux.make_flux_spec(d, cl, cr)
            if self.traced:
                self.sync()
                t = time.perf_counter() - t
        with span("solve"):
            res = self.multigrid.solve_mgcg_batched(coeffs, spec, self.x0,
                                                    **self.kw)
        with span("readback"):
            deff = res.deff.cpu()
        return res, deff, t

    def warm_up(self):
        self._solve(0)

    def request(self, k: int):
        return (k,) + self._solve(k)

    def after(self, k: int, handle) -> dict:
        _, res, deff, t_asm = handle
        iters = res.iters.cpu().numpy()
        conv = res.conv.cpu().numpy()
        deff = deff.double().numpy()

        def keep(i):
            return (k, i, res.x[i].clone(), float(deff[i]), float(conv[i]))

        self.kept.offer(len(deff), keep, iters)
        return dict(solves=len(deff), failed=int(np.sum(~np.isfinite(deff))),
                    iters=iters, assembly_s=t_asm)

    def release(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        cfg, lim = self.cfg, self.cfg["check"]["limits"]
        items = self.kept.items()
        solid = torch.stack([self.solid[gen.round_robin(k, self.pool), i]
                             for k, i, *_ in items])
        x = torch.stack([it[2] for it in items]).double()
        d = fvm2d.diffusivity(~solid, cfg["d_fluid"], cfg["d_solid"])
        s = fvm2d.system(d, cfg["c_left"], cfg["c_right"])
        resid = fvm2d.mean_abs_residual(s, x).cpu().numpy()
        ref = fvm2d.deff(d, x, cfg["c_left"], cfg["c_right"]).cpu().numpy()
        got = np.array([it[3] for it in items])
        gap = np.abs(got - ref) / np.abs(ref)
        return [("resid_ratio", float(np.max(resid)) / self.kw["tol"],
                 lim["resid_ratio"]),
                ("deff_gap", float(np.max(gap)), lim["deff_gap"])]

    def control(self, picks: list) -> list:
        """The control's answers to ``picks`` (``(request, image)`` pairs),
        in the precision below the configuration's, on the pool batches that
        hold them: the program's own solve in it, or, where the program has
        none, the reference in its place: ``max_iter`` damped-Jacobi sweeps
        (``REFERENCE_OMEGA``) from the linear start."""
        name = lower_dtype(self.cfg)
        low = getattr(torch, name)
        cl, cr = self.cfg["c_left"], self.cfg["c_right"]
        done = {}
        for p in sorted({gen.round_robin(k, self.pool) for k, _ in picks}):
            d = self.fields[p].to(low)
            if name in PROGRAM_DTYPES:
                res = self.multigrid.solve_mgcg_batched(
                    self.fvm.fvm_coefficients(d, cl, cr),
                    self.flux.make_flux_spec(d, cl, cr), self.x0.to(low),
                    **self.kw)
                x, deff, conv = res.x, res.deff, res.conv
            else:
                x = jacobi.relax(d, c_left=cl, c_right=cr,
                                 omega=REFERENCE_OMEGA,
                                 sweeps=self.kw["max_iter"])
                deff = fvm2d.deff(d, x, cl, cr)
                conv = fvm2d.mean_abs_residual(fvm2d.system(d, cl, cr), x)
            done[p] = (x, deff.double().cpu().numpy(),
                       conv.double().cpu().numpy())
        out = []
        for k, i in picks:
            x, deff, conv = done[gen.round_robin(k, self.pool)]
            out.append((k, i, x[i].clone(), float(deff[i]), float(conv[i])))
        return out

    def work(self) -> dict:
        return dict(kind="mgcg", itemsize=self.dtype.itemsize,
                    nu=self.kw["nu1"],
                    window=self.kw["check_every"],
                    first_window=self.kw["first_window"],
                    cells=hierarchy_cells(self.size, self.size,
                                          self.kw["min_size"]))

