#!/usr/bin/env python3
"""Drive the torch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each; any failure raises and exits non-zero):

1. device: CUDA must be available; prints the card, the device count and
   ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels from the checkout's sources;
3. K2 (V-cycle) against its plain PyTorch version on the card, B=8 x 512^2;
4. K1 (fused CG steps) against its plain version on the card, B=8 x 512^2,
   k=5, with a frozen image, one that exits at iteration 0 and one tripped
   by its divergence threshold;
5. the slice: bench.py's problem (B=512 images of 512^2, fp32, the bench
   solver settings) through ``solve_mgcg_batched`` on the kernels, checked
   for convergence, Deff range and kernel launches, the first 16 images
   solved again through the plain versions, then one warm-up and three
   timed solves;
6. kernel times at the main path's shapes (CUDA events) against the plain
   versions.

The last lines are a JSON object describing the kernels, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np

BATCH, SIZE = 512, 512
POROSITY, CONTRAST = 0.65, 1e-6
SOLVE_KW = dict(tol=1e-6, max_iter=3000, check_every=40,
                criterion="residual", min_size=8, coarse_iters=8, nu1=2,
                nu2=2, over=1.8, mg_omega=(1.281, 0.5584), first_window=40)
MG = dict(omega=SOLVE_KW["mg_omega"], nu=2, coarse_iters=8, over=1.8)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_images(batch, n):
    """bench.py's generator: Gaussian-smoothed noise (sigma 4) thresholded at
    the porosity quantile; pixels above it are solid (255)."""
    from scipy import ndimage

    rng = np.random.default_rng(7)
    imgs = np.empty((batch, n, n), np.uint8)
    for i in range(batch):
        noise = ndimage.gaussian_filter(rng.standard_normal((n, n)), sigma=4.0)
        imgs[i] = (noise >= np.quantile(noise, POROSITY)) * 255
    return imgs


def build_problem(imgs, dev):
    import torch

    from effectivediffusivityfvm_tpu_torch.models import phases
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec

    classes = phases.two_phase_classes(imgs)
    d = torch.tensor(phases.d_field_from_classes(classes, 1.0, CONTRAST,
                                                 dtype=np.float32), device=dev)
    coeffs = fvm.fvm_coefficients(d, 0.0, 1.0)
    spec = make_flux_spec(d, 0.0, 1.0)
    bsz, n = imgs.shape[0], imgs.shape[-1]
    x0 = (torch.arange(n, dtype=torch.float32, device=dev) / n).expand(
        bsz, n, n)
    return coeffs, spec, x0


def cuda_ms(fn, reps, warm=1):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after
    ``warm`` untimed ones, by CUDA events around the whole run."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.kernels import _build
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
        batch_sum, cg_steps, cg_steps_reference)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import (
        v_cycle, v_cycle_reference)
    from effectivediffusivityfvm_tpu_torch.solvers import multigrid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    card = f"[{smi}]"
    print(f"phase 1 device: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    # -- 2: build
    info = _build.build_info()
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", info["log"])]
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", info["log"])]
    print(f"phase 2 build: {info['seconds']:.1f} s, {len(regs)} kernels, "
          f"registers {min(regs, default=0)}..{max(regs, default=0)}, "
          f"spill bytes {sum(spills)}", flush=True)

    # -- 3: K2 against its plain version, B=8 x 512^2
    imgs = bench_images(BATCH, SIZE)
    c8, _, x8 = build_problem(imgs[:8], dev)
    lv8 = multigrid.build_hierarchy(c8, min_size=8, pad_levels=True)
    x8 = x8.contiguous()
    r8 = lv8[0].b - fvm.apply_operator(lv8[0], x8)
    z_k = v_cycle(lv8, r8, **MG)
    z_p = v_cycle_reference(lv8, r8, **MG)
    torch.cuda.synchronize()
    k2_err = float((z_k - z_p).abs().max())
    k2_scale = float(z_p.abs().max())
    check(k2_err <= 1e-4 * k2_scale,
          f"K2 max|z_k - z_p| {k2_err} > 1e-4 * {k2_scale}")
    print(f"phase 3 K2 vs plain: max abs err {k2_err:.3e} "
          f"(max|z| {k2_scale:.3e}, {len(lv8)} levels)", flush=True)

    # -- 4: K1 against its plain version, B=8 x 512^2, k=5
    p8 = v_cycle(lv8, r8, **MG)
    rz = batch_sum(r8 * p8)
    sr0 = batch_sum(r8.abs())
    active = torch.ones(8, device=dev)
    active[5] = 0.0                              # frozen
    stop = torch.zeros(8, device=dev)
    stop[6] = 10.0 * sr0[6]                      # exits at iteration 0
    hi = torch.full((8,), float("inf"), device=dev)
    rz[7] *= 1e3                                 # overshoots ...
    hi[7] = 2.0 * sr0[7]                         # ... and trips its hi
    state = (x8, r8, p8, rz, active, stop, hi)
    got = cg_steps(lv8, *(t.clone() for t in state), 5, **MG)
    ref = cg_steps_reference(lv8, *(t.clone() for t in state), 5, **MG)
    torch.cuda.synchronize()
    kd = got[4].tolist()
    check(kd == ref[4].tolist(), f"K1 k_done {kd} != plain {ref[4].tolist()}")
    check(kd == [5, 5, 5, 5, 5, 0, 0, 1], f"K1 k_done {kd}")
    k1_err = 0.0
    for nm, g, e in zip("xrp", got[:3], ref[:3]):
        for b in range(8):
            err = float((g[b] - e[b]).abs().max())
            scale = float(e[b].abs().max())
            check(err <= 1e-4 * scale, f"K1 {nm}[{b}] err {err} > 1e-4*{scale}")
            k1_err = max(k1_err, err)
    for nm, g, e in (("rz", got[3], ref[3]), ("sum|r_true|", got[5], ref[5])):
        check(bool(torch.allclose(g, e, rtol=1e-3, atol=0)),
              f"K1 {nm} {g.tolist()} vs {e.tolist()}")
    for g, s in zip(got[:4], state[:4]):
        check(bool(torch.equal(g[5], s[5])), "K1 frozen image changed")
    check(float(got[5][5]) == 0.0, "K1 frozen sum|r_true| != 0")
    print(f"phase 4 K1 vs plain: k_done {kd}, max abs err x/r/p "
          f"{k1_err:.3e}", flush=True)
    del c8, lv8, x8, r8, z_k, z_p, p8, got, ref, state

    # -- 5: the slice at B=512 x 512^2
    coeffs, spec, x0 = build_problem(imgs, dev)
    torch.cuda.synchronize()
    v_cycle.launches = 0
    cg_steps.launches = 0
    t0 = time.perf_counter()
    res = multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {"cg_steps": cg_steps.launches, "v_cycle": v_cycle.launches}
    conv = res.conv.cpu().numpy()
    deff = res.deff.cpu().numpy()
    iters = res.iters.cpu().numpy()
    check(launches["cg_steps"] > 0 and launches["v_cycle"] > 0,
          f"kernel launches {launches}")
    check(bool(np.all(conv <= SOLVE_KW["tol"])),
          f"{int(np.sum(conv > SOLVE_KW['tol']))} images not converged, "
          f"max conv {conv.max()}")
    check(bool(np.all(np.isfinite(deff)) and np.all(deff > 0)
               and np.all(deff <= 1)), f"Deff out of (0, 1]: "
          f"{deff.min()}..{deff.max()}")
    print(f"phase 5 slice: B={BATCH} x {SIZE}^2 solved in {t_first:.3f} s "
          f"(first run), iters {iters.min()}..{iters.max()}, max conv "
          f"{conv.max():.3e}, Deff {deff.min():.5f}..{deff.max():.5f}, "
          f"launches {launches}", flush=True)

    sub = slice(0, 16)
    plain = multigrid._mgcg_core(
        type(coeffs)(*(a[sub] for a in coeffs)),
        type(spec)(*(a[sub] for a in spec)), x0[sub], batched=True,
        kernels=(cg_steps_reference, v_cycle_reference), **SOLVE_KW)
    p_deff = plain.deff.cpu().numpy()
    p_iters = plain.iters.cpu().numpy()
    rel = np.abs(deff[sub] - p_deff) / np.abs(p_deff)
    d_it = np.abs(iters[sub].astype(int) - p_iters.astype(int))
    check(bool(np.all(rel <= 5e-3)), f"Deff vs plain rel err {rel.max()}")
    check(bool(np.all(d_it <= 3)), f"iterations vs plain differ by {d_it.max()}")
    print(f"phase 5 slice vs plain (16 images): Deff max rel err "
          f"{rel.max():.3e}, iterations max diff {d_it.max()}", flush=True)

    multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    iters = res.iters.cpu().numpy()
    print(f"phase 5 timed {card}: {BATCH / min(times):.1f} solves/s "
          f"(runs {', '.join(f'{t:.4f}' for t in times)} s), iters "
          f"{iters.min()}..{iters.max()} (mean {iters.mean():.2f}), peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    del res, plain

    # -- 6: kernel times at the main path's shapes (B=512 x 512^2)
    lv = multigrid.build_hierarchy(coeffs, min_size=8, pad_levels=True)
    x = x0.contiguous().clone()
    r = lv[0].b - fvm.apply_operator(lv[0], x)
    lib = _build.load_library()
    n0 = lib.deff_launch_count()
    v_cycle(lv, r, **MG)
    per_cycle = lib.deff_launch_count() - n0
    ms_k2 = cuda_ms(lambda: v_cycle(lv, r, **MG), 10, warm=2)
    ms_k2p = cuda_ms(lambda: v_cycle_reference(lv, r, **MG), 3)
    p = v_cycle(lv, r, **MG)
    ones = torch.ones(BATCH, device=dev)
    zero = torch.zeros(BATCH, device=dev)
    inf = torch.full((BATCH,), float("inf"), device=dev)
    rz = batch_sum(r * p)

    def k1(fn, k=5):
        return fn(lv, x, r, p, rz, ones, zero, inf, k, **MG)

    n0 = lib.deff_launch_count()
    k1(cg_steps, 0)
    n1 = lib.deff_launch_count()
    k1(cg_steps, 5)
    per_iter = (lib.deff_launch_count() - n1 - (n1 - n0)) / 5
    ms_k1 = cuda_ms(lambda: k1(cg_steps), 3)
    ms_k1p = cuda_ms(lambda: k1(cg_steps_reference), 2)
    print(f"phase 6 kernel times {card}, B={BATCH} x {SIZE}^2 fp32: "
          f"K2 v_cycle {ms_k2:.3f} ms (plain {ms_k2p:.3f} ms, "
          f"{per_cycle} launches/cycle); K1 cg_steps k=5 {ms_k1:.3f} ms "
          f"(plain {ms_k1p:.3f} ms, {per_iter:g} launches/iteration)",
          flush=True)

    kernels = [
        {"name": "cg_steps", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/cgstep.cu",
         "replaces": "effectivediffusivityfvm_tpu/ops/kernels/cgstep_vmem.py:166",
         "launches": launches["cg_steps"], "max_abs_err": k1_err,
         "ms": ms_k1, "plain_ms": ms_k1p},
        {"name": "v_cycle", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/vcycle.cuh",
         "replaces": "effectivediffusivityfvm_tpu/ops/kernels/vcycle_vmem.py:276",
         "launches": launches["v_cycle"], "max_abs_err": k2_err,
         "ms": ms_k2, "plain_ms": ms_k2p},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
