#!/usr/bin/env python3
"""Time the port's main-path kernels and solves with the package of one
checkout, to compare two checkouts on one card in turns.

    python3 turns.py [--tree DIR]

imports ``effectivediffusivityfvm_tpu_torch`` from DIR (default: this
checkout; its kernels build into DIR/build/kernels) and prints one JSON
line with the card and, on the problems of ``chip_smoke.py`` (this
checkout's):

* K2's whole cycle at B=512 x 512^2 fp32 (ms by CUDA events, launches a
  cycle) and K1's k=5 call there (ms, launches an iteration);
* the MGCG slice (bench.py's problem): solves/s, best of three, and the
  iterations;
* BASELINE config 3 (one 2048^2 image), stored and matrix-free: seconds,
  best of three;
* K4's banded cycle on that image (B=1 x 2048^2: ms a call by CUDA
  events, device ms, and each launch's device time in launch order: T1,
  K2's tail, T2) and K5's k=10 call there (stored and matrix-free; ms by
  CUDA events);
* K8: one application of the sharded cycle on that image at SP=4 on the
  card (ms a call, device ms of all its work and of K8's own kernels,
  each launch's device time);
* K9: a call of k=10 iterations on that image at SP=4 on the card, as the
  solver makes it (the tree's ``fused2d.k9_coarse`` where it has one; each
  call restores x, r and p first, three plane copies inside the time): ms
  a call by CUDA events, device ms, each pass's device ms and the graph
  replays a call;
* config 3 through ``sharded_solve_mgcg`` on four shards of the card and on
  one: seconds, best of three, iterations and Deff;
* K6 on BASELINE config 5's volume (B=1 x 256^3 fp32): the banded cycle
  and the whole cycle on levels[1:] as K7 and the banded cycle call it (ms
  a wrapper call by CUDA events, device ms by the profiler, launches a
  cycle);
* K7's k=5 call on that volume (stored and matrix-free) and config 5's
  solve on both legs: seconds, best of three, and iterations.

With ``--only3d`` it times the last two items alone, with each K6 launch's
device time in launch order; with ``--config3`` config 3's two unsharded
legs alone (for many pairs of runs in turns).

To compare a parent commit with this tree, unpack it under ``build/`` and
run the two alternately in one call on the card:

    mkdir -p build/parent && git archive PARENT | tar -x -C build/parent
    for t in build/parent . . build/parent; do python3 turns.py --tree $t; done

It needs a CUDA device and exits non-zero without one.
"""

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--only3d", action="store_true",
                    help="time K6, K7 and config 5 only")
    ap.add_argument("--config3", action="store_true",
                    help="time config 3's unsharded solves only")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("turns: no CUDA device; nothing was run")
    import effectivediffusivityfvm_tpu_torch as pkg
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.kernels import _build
    from effectivediffusivityfvm_tpu_torch.ops import fvm3d
    from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle3d as v3
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
        batch_sum, cg_steps)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep3d import \
        cg_steps3d
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import \
        cg_steps_tiled
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import v_cycle
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_tiled import \
        v_cycle_tiled
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, halo, mesh
    from effectivediffusivityfvm_tpu_torch.solvers import multigrid, solvers3d

    if Path(pkg.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"turns: imported {pkg.__file__}, not from {tree}")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t_build = time.perf_counter()
    lib = _build.load_library()
    out = {"tree": str(tree), "card": smi,
           "build_s": time.perf_counter() - t_build}

    def best_of_3(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        return min(times), times, res

    def window_ms(fn, levels, x, r, p, k, mg, extra, reps=3):
        """ms of one CG window call of ``k`` iterations on B=1 (every
        iteration live), each call on a fresh copy of the state."""
        rz = batch_sum(r * p)
        one = torch.ones(1, dtype=x.dtype, device=dev)
        states = [(x.clone(), r.clone(), p.clone()) for _ in range(reps + 1)]
        return cs.cuda_ms(lambda: fn(levels, *states.pop(), rz, one, 0 * one,
                                     one * float("inf"), k, **mg, **extra),
                          reps)

    if args.config3:
        rng = np.random.default_rng(cs.C3_SEED)
        img = cs.correlated_binary(rng, cs.C3_SIZE, cs.C3_SIZE)
        d, c, s, x0 = cs.c3_problem(img, dev)
        for name, kw in (("config3", dict(cs.C3_KW, first_window=0)),
                         ("config3_mf", dict(cs.C3_KW, d_field=d,
                                             first_window=1))):
            t, times, res = best_of_3(
                lambda: multigrid.solve_mgcg(c, s, x0, **kw))
            out[f"{name}_s"], out[f"{name}_runs_s"] = t, times
            out[f"{name}_iterations"] = int(res.iters)
        print(json.dumps(out), flush=True)
        return
    if not args.only3d:
        # the MGCG slice's problem, B=512 x 512^2 (images cached)
        cache = HERE / "build" / "turns_images.npy"
        if cache.exists():
            imgs = np.load(cache)
        else:
            imgs = cs.bench_images(cs.BATCH, cs.SIZE)
            cache.parent.mkdir(parents=True, exist_ok=True)
            np.save(cache, imgs)
        coeffs, spec, x0 = cs.build_problem(imgs, dev)
        lv = multigrid.build_hierarchy(coeffs, min_size=8, pad_levels=True)
        x = x0.contiguous().clone()
        r = lv[0].b - fvm.apply_operator(lv[0], x)
        n0 = lib.deff_launch_count()
        v_cycle(lv, r, **cs.MG)
        out["k2_launches_a_cycle"] = lib.deff_launch_count() - n0
        out["k2_ms"] = cs.cuda_ms(lambda: v_cycle(lv, r, **cs.MG), 10, warm=2)
        p = v_cycle(lv, r, **cs.MG)
        b = x.shape[0]
        ones, zero = torch.ones(b, device=dev), torch.zeros(b, device=dev)
        inf = torch.full((b,), float("inf"), device=dev)
        rz = batch_sum(r * p)

        def k1(k=5):
            return cg_steps(lv, x, r, p, rz, ones, zero, inf, k, **cs.MG)

        n0 = lib.deff_launch_count()
        k1(0)
        n1 = lib.deff_launch_count()
        k1(5)
        out["k1_launches_an_iteration"] = (lib.deff_launch_count() - n1
                                           - (n1 - n0)) / 5
        out["k1_ms"] = cs.cuda_ms(k1, 3)
        del lv, x, r, p
        t, times, res = best_of_3(lambda: multigrid.solve_mgcg_batched(
            coeffs, spec, x0, **cs.SOLVE_KW))
        iters = res.iters.cpu().numpy()
        out["slice_solves_per_s"] = cs.BATCH / t
        out["slice_runs_s"] = times
        out["slice_iterations"] = [int(iters.min()), int(iters.max())]
        del coeffs, spec, x0, res
        torch.cuda.empty_cache()


        # BASELINE config 3, unsharded (stored) and sharded, and K5 on it
        rng = np.random.default_rng(cs.C3_SEED)
        img = cs.correlated_binary(rng, cs.C3_SIZE, cs.C3_SIZE)
        d, c, s, x0 = cs.c3_problem(img, dev)
        kw = dict(cs.C3_KW, first_window=0)
        t, times, res = best_of_3(lambda: multigrid.solve_mgcg(c, s, x0, **kw))
        out["config3_s"], out["config3_runs_s"] = t, times
        out["config3_iterations"] = int(res.iters)
        t, times, res = best_of_3(lambda: multigrid.solve_mgcg(
            c, s, x0, **cs.C3_KW, d_field=d, first_window=1))
        out["config3_mf_s"], out["config3_mf_runs_s"] = t, times
        out["config3_mf_iterations"] = int(res.iters)
        levels, x, mf = cs.tiled_setup(d[None], type(c)(*(a[None] for a in c)),
                                       x0[None], cs.C3_KW["min_size"])
        r = levels[0].b - fvm.apply_operator(levels[0], x)

        def k4():
            return v_cycle_tiled(levels, r, **cs.MG3)

        n0 = lib.deff_launch_count()
        k4()
        out["k4_launches"] = lib.deff_launch_count() - n0
        out["k4_ms"] = cs.cuda_ms(k4, 10, warm=2)
        out["k4_device_ms"] = cs.device_ms(k4, 10)
        out["k4_launch_us"] = cs.launch_us(k4, 10)
        p = k4()
        for mode, extra in (("stored", {}), ("mf", mf)):
            out[f"k5_{mode}_ms"] = window_ms(cg_steps_tiled, levels, x, r, p,
                                             cs.K5_TIME_K, cs.MG3, extra)
        del levels, x, mf, r, p
        # K8: one application of the sharded cycle, B=1 x 2048^2 at SP=4 on
        # the card (its tables kept across calls where the tree has them)
        cb = type(c)(*(a[None] for a in c))
        m, hier, cw, tail = cs.sharded_setup(cb, 4, dev, cs.C3_KW["min_size"])
        rs = mesh.shard_rows(m, cb.b - fvm.apply_operator(cb, x0[None]))[0]
        kw8 = dict(tail=tail, **cs.MG3)
        if "rows" in inspect.signature(
                fused2d.v_cycle_sharded_fused).parameters:
            kw8["rows"] = {}

        def k8():
            return fused2d.v_cycle_sharded_fused(hier, cw, rs, **kw8)

        n0 = lib.deff_launch_count()
        k8()
        out["k8_launches"] = lib.deff_launch_count() - n0
        out["k8_ms"] = cs.cuda_ms(k8, 10, warm=2)
        own = cs.kernel_device_us(k8, 10, ("row_t1", "row_t2", "shard_t1",
                                           "shard_t2"))
        out["k8_own_device_ms"] = None if own is None else own[0] / 1e3
        out["k8_device_ms"] = None if own is None else own[1] / 1e3
        out["k8_launch_us"] = cs.launch_us(k8, 5)
        # K9: k=10 iterations at SP=4, B=1, every image live
        from effectivediffusivityfvm_tpu_torch.ops.kernels import \
            cgstep_sharded as k9mod

        rb = cb.b - fvm.apply_operator(cb, x0[None])
        pb = torch.cat(k8(), dim=-2)
        rzb = batch_sum(rb * pb)
        one = torch.ones(1, device=dev)
        fresh = [mesh.shard_rows(m, t)[0] for t in (x0[None], rb, pb)]
        state = [[t.clone() for t in shards] for shards in fresh]
        if hasattr(fused2d, "k9_coarse"):
            kw9 = fused2d.k9_coarse(hier, cw, state[0], tail=tail, **cs.MG3)
            kw9["workspace"] = k9mod.ShardWorkspace(
                cw[0], state[0], True, kw9.get("coarse_plane"))
        else:
            kw9 = dict(coarse=lambda rc, live: fused2d.v_cycle_sharded_fused(
                hier, cw, rc, level=1, tail=tail, live=live, **cs.MG3),
                workspace=k9mod.ShardWorkspace(cw[0], state[0]))

        def k9():
            for dst, src in zip(state, fresh):
                for a, b in zip(dst, src):
                    a.copy_(b)
            return k9mod.cg_steps_sharded(
                cw[0], *state, rzb, one, 0 * one, one * float("inf"),
                cs.K9_TIME_K, omega=cs.MG3["omega"], nu=cs.MG3["nu"],
                over=cs.MG3["over"], **kw9)

        k9()
        r0 = k9mod.cg_steps_sharded.replays
        k9()
        out["k9_replays_a_call"] = k9mod.cg_steps_sharded.replays - r0
        out["k9_ms"] = cs.cuda_ms(k9, 5, warm=1)
        out["k9_device_ms"] = cs.device_ms(k9, 3)
        for nm, frags in zip("pxz", (("shard_p_kernel", "shard_pass_a"),
                                     ("shard_x_kernel", "shard_pass_b"),
                                     ("shard_z_kernel", "shard_pass_c"))):
            own = cs.kernel_device_us(k9, 3, frags)
            out[f"k9_pass_{nm}_device_ms"] = (None if own is None
                                              else own[0] / 1e3)
        del cb, m, hier, cw, tail, rs, kw8, kw9, state, fresh, rb, pb
        for sp in (4, 1):
            m = mesh.make_mesh(sp, devices=[dev] * sp)
            t, times, res = best_of_3(
                lambda: halo.sharded_solve_mgcg(c, s, x0, m, **kw))
            out[f"config3_sp{sp}_s"], out[f"config3_sp{sp}_runs_s"] = t, times
            out[f"config3_sp{sp}_iterations"] = int(res.iters)
            out[f"config3_sp{sp}_deff"] = float(res.deff)
        del c, s, x0, d, res
        torch.cuda.empty_cache()

    # BASELINE config 5: K7 on its volume, then the solve on both legs
    fluid = cs.c5_fluid((cs.C5_SIZE,) * 3, cs.C5_SEED)
    d5, c5, s5, x05 = cs.c5_problem(fluid, dev)
    levels, x, mf = cs.tiled3d_setup(d5[None],
                                     type(c5)(*(a[None] for a in c5)),
                                     x05[None])
    r = levels[0].b - fvm3d.apply_operator_3d(levels[0], x)
    r1 = torch.randn(levels[1].diag.shape, dtype=r.dtype, device=dev)
    for name, fn in (("k6_banded", lambda: v3.v_cycle3d_tiled(
            levels, r, **cs.MG5)), ("k6_whole", lambda: v3.v_cycle3d(
                levels[1:], r1, **cs.MG5))):
        n0 = lib.deff_launch_count()
        fn()
        n = lib.deff_launch_count() - n0
        out[f"{name}_launches"] = n
        out[f"{name}_ms"] = cs.cuda_ms(fn, 10, warm=2)
        out[f"{name}_device_ms"] = cs.device_ms(fn, 5)
        out[f"{name}_launch_us"] = cs.launch_us(fn, 5)
    p = v3.v_cycle3d_tiled(levels, r, **cs.MG5)
    for mode, extra in (("stored", {}), ("mf", mf)):
        out[f"k7_{mode}_ms"] = window_ms(cg_steps3d, levels, x, r, p,
                                         cs.K7_TIME_K, cs.MG5, extra)
    del levels, x, mf, r, r1, p
    for name, extra in (("mf", dict(d_field=d5)), ("stored", {})):
        t, times, res = best_of_3(lambda: solvers3d.solve_mgcg_3d(
            c5, s5, x05, **cs.C5_KW, **extra))
        out[f"config5_{name}_s"], out[f"config5_{name}_runs_s"] = t, times
        out[f"config5_{name}_iterations"] = int(res.iters)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
