"""Entry ``batch_sim``: a request is one ``pipeline/batch.py::batch_sim`` call,
the upstream batch mode as the port serves it: 8-bit images in, host
preparation (porosity, flood fill) on its worker thread, classification,
assembly, the configured solver, and the output table with its CSV (under
the run's ``TMPDIR``, removed before each call so that no call resumes
another).

Traffic keys: ``images_per_call``, ``size`` (pixels a side), ``pool_calls``
(distinct calls' images made at set-up, taken round-robin).

The table holds no iteration counts: the entry reads each solve's sweeps
from the third return of ``pipeline/batch.py::solve_image_group``, which
``batch_sim`` calls once a shape group, by wrapping that function for the
entry's life; a call that does not pass through it fails with a message.

The output check runs the upstream protocol again in the reference
(``reference/jacobi.py``, in the configuration's precision) on a sample of
the window's images and compares the Deff column; the porosity and PathFlag
columns against the reference's own.  It holds only for the protocol's
solvers (``JACOBI_SOLVERS``); another solver is refused by name, and a cell
of one brings its own entry.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from .. import gen
from ..control import PROGRAM_DTYPES, lower_dtype
from ..reference import fvm2d, jacobi
from ..sample import Reservoir
from ..trace import span

# the solvers whose output the reference's Jacobi protocol judges
JACOBI_SOLVERS = ("jacobi", "jacobi_pallas")
# configuration solver keys named otherwise in ``SimulationConfig``
SIM_FIELDS = {"name": "solver", "tol": "convergence"}


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 traced: bool = False):
        from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
        from effectivediffusivityfvm_tpu_torch.pipeline import batch

        self.batch_mod = batch
        self.cfg, self.dev = config, torch.device(device)
        self.per_call, self.size = traffic["images_per_call"], traffic["size"]
        self.per_request = self.per_call
        self.pool = traffic["pool_calls"]
        med = config["medium"]
        imgs = gen.pixels(gen.solid_masks(
            gen.generator(seed, self.dev), self.per_call * self.pool,
            self.size, sigma=med["sigma"], porosity=med["porosity"]))
        imgs = imgs.cpu().numpy()
        self.imgs = [list(imgs[p * self.per_call:(p + 1) * self.per_call])
                     for p in range(self.pool)]
        self.csv = os.path.join(tempfile.gettempdir(),
                                f"portbench-{os.getpid()}.csv")
        solver = {SIM_FIELDS.get(k, k): v
                  for k, v in config["solver"].items()}
        unknown = set(solver) - {f.name for f in
                                 dataclasses.fields(SimulationConfig)}
        if unknown:
            raise ValueError(f"solver keys {sorted(unknown)} are not "
                             "SimulationConfig fields")
        self.kind = ("jacobi" if solver["solver"] in JACOBI_SOLVERS
                     else None)
        self.sim = SimulationConfig(
            n_phase=2, d_fluid=config["d_fluid"], d_solid=config["d_solid"],
            c_left=config["c_left"], c_right=config["c_right"],
            dtype=config["dtype"], batch_flag=True, num_images=self.per_call,
            output_name=self.csv, **solver)
        self.kept = Reservoir(config["check"]["sample"],
                              gen.host_rng(seed, 1))
        self.seen = []                   # each group solve's sweep counts
        self._solve_group = batch.solve_image_group

        def observed(*a, **kw):
            out = self._solve_group(*a, **kw)
            self.seen.append(np.asarray(out[2]))
            return out

        batch.solve_image_group = observed

    def _call(self, k: int, sim):
        if os.path.exists(self.csv):
            os.unlink(self.csv)
        self.seen.clear()
        return self.batch_mod.batch_sim(
            sim, imgs=self.imgs[gen.round_robin(k, self.pool)],
            device=self.dev.type)

    def warm_up(self):
        # the cell's shapes and every route of a call, with fewer windows
        every = self.sim.check_every
        self._call(0, dataclasses.replace(self.sim, max_iter=2 * every + 1)
                   if every else self.sim)

    def request(self, k: int):
        with span("batch_sim"):
            return k, self._call(k, self.sim)

    def after(self, k: int, handle) -> dict:
        _, table = handle
        if not self.seen:
            raise RuntimeError(
                "batch_sim did not call pipeline.batch.solve_image_group, "
                "whose third return the entry reads the solves' iteration "
                "counts from: read them where the pipeline now returns them")
        iters = np.concatenate(self.seen)
        deff = table[:, 3]

        def keep(i):
            return (k, i, float(deff[i]), float(table[i, 1]),
                    int(table[i, 2]))

        self.kept.offer(len(deff), keep, iters)
        return dict(solves=len(deff), failed=int(np.sum(~np.isfinite(deff))),
                    iters=iters)

    def release(self):
        self.batch_mod.solve_image_group = self._solve_group
        if os.path.exists(self.csv):
            os.unlink(self.csv)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _judged_protocol(self):
        if self.kind != "jacobi":
            raise NotImplementedError(
                f"batch_sim's output check is the upstream Jacobi protocol; "
                f"solver {self.sim.solver!r} needs an entry with a check of "
                "its own")

    def _reference(self, picks, dtype):
        """The reference's Deff, porosity and PathFlag of the images that
        ``picks`` (``(request, image, ...)``) name, its protocol run in
        ``dtype``."""
        cfg, sol = self.cfg, self.cfg["solver"]
        img = torch.as_tensor(np.stack([
            self.imgs[gen.round_robin(k, self.pool)][i] for k, i, *_ in picks]),
            device=self.dev)
        fl = fvm2d.fluid(img)
        poro = fvm2d.porosity(img).cpu().numpy()
        flags = np.array([fvm2d.path_flag(f) for f in fl.cpu().numpy()])
        d = fvm2d.diffusivity(fl, cfg["d_fluid"], cfg["d_solid"],
                              dtype=getattr(torch, dtype))
        ref, _ = jacobi.solve(d, c_left=cfg["c_left"], c_right=cfg["c_right"],
                              omega=sol["omega"], tol=sol["tol"],
                              max_iter=sol["max_iter"],
                              check_every=sol["check_every"])
        return ref / cfg["d_fluid"], poro, flags

    def check(self) -> list:
        self._judged_protocol()
        lim = self.cfg["check"]["limits"]
        items = self.kept.items()
        ref, poro, flags = self._reference(items, "float64")
        got = np.array([it[2] for it in items])
        return [
            ("deff_gap", float(np.max(np.abs(got - ref) / np.abs(ref))),
             lim["deff_gap"]),
            ("porosity_gap",
             float(np.max(np.abs(np.array([it[3] for it in items]) - poro))),
             lim["porosity_gap"]),
            ("pathflag_miss",
             float(np.sum(np.array([it[4] for it in items]) != flags)),
             lim["pathflag_miss"])]

    def control(self, picks: list) -> list:
        """The control's answers to ``picks`` (``(request, image)`` pairs),
        in the precision below the configuration's: the program's own path
        in it (``Dtype:``) on the calls that hold them, or, where the
        program has none, the reference's protocol in it."""
        self._judged_protocol()
        low = lower_dtype(self.cfg)
        if low not in PROGRAM_DTYPES:
            deff, poro, flags = self._reference(picks, low)
            return [(k, i, float(deff[n]), float(poro[n]), int(flags[n]))
                    for n, (k, i) in enumerate(picks)]
        sim = dataclasses.replace(self.sim, dtype=low)
        tables = {}
        for k in sorted({gen.round_robin(k, self.pool) for k, _ in picks}):
            tables[k] = self._call(k, sim)
        out = []
        for k, i in picks:
            row = tables[gen.round_robin(k, self.pool)][i]
            out.append((k, i, float(row[3]), float(row[1]), int(row[2])))
        return out

    def work(self) -> dict:
        return dict(kind=self.kind,
                    itemsize=getattr(torch, self.cfg["dtype"]).itemsize,
                    cells=self.size * self.size,
                    check_every=self.sim.check_every)
