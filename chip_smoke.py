#!/usr/bin/env python3
"""Drive the torch port's paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (one line each, with its seconds; any failure raises and exits
non-zero):

1. device: CUDA must be available; prints the card, the device count and
   ``nvidia-smi``'s name and power limit;
2. build: compiles the port's CUDA kernels from the checkout's sources;
3. K2 (V-cycle) against its plain PyTorch version on the card, bit for bit:
   B=8 x 512^2 in float32 and float64 with two images gated, and config
   3's K2 tail (levels 1.. of the banded 2048^2 hierarchy), each in the
   launches of the resident rule (two tile passes a level, one launch for
   the resident bottom);
4. K1 (fused CG steps, three tile passes an iteration) against its plain
   version on the card, B=8 x 512^2, k=5, with a frozen image, one that
   exits at iteration 0 and one tripped by its divergence threshold; its
   launches an iteration and reckoned bytes a cell an iteration;
5. the MGCG slice: bench.py's problem (B=512 images of 512^2, fp32, the
   bench solver settings) through ``solve_mgcg_batched`` on the kernels,
   checked for convergence, Deff range and kernel launches, the first 16
   images solved again through the plain versions, then one warm-up and
   three timed solves;
6. K1/K2 times at the main path's shapes (CUDA events) against the plain
   versions, K2's launches a cycle and K1's an iteration, then one K1 call
   and one slice solve under ``torch.profiler`` (``turns.py`` times them
   against another checkout's package in turns);
7. K3 (Jacobi sweeps) against its plain version on the card, bit for bit:
   B=8 at 128^2 (k = 1, 37 and 10000) and 96x160 (k = 1, 37) on the
   resident route, one launch a call, and 512^2 (k = 1, 37) on the
   streaming route, fp32 and fp64, image 5 frozen;
8. the CLI batch path at full size (the reference's datagen mode): an
   ``input.txt`` with ``Solver: jacobi_pallas``, parsed by the port and run
   through ``batch_sim`` on 256 images of 128^2 to the reference protocol
   (Deff criterion, tol 1e-5, a check every 10000 sweeps, MaxIter 5e5);
   the first 8 images solved again through K3's plain version at a cap of
   20001 sweeps;
9. BASELINE config 1's shape: one 128^2 image through ``single_sim`` in
   fp64 on K3, the plain sweep against K3 at 20001 sweeps, and the 2- and
   3-phase parallel slabs against their analytic Deff;
10. ``batch_sim`` with ``Solver: mgcg`` on 64 of phase 5's images, which
    reaches K1/K2 through the CLI path, against the same solve called
    directly with the pipeline's settings;
11. config 1 and the CLI batch under ``torch.profiler``; K3 times (CUDA
    events) at B=256 x 128^2 fp32 and B=1 x 128^2 fp64, the resident and
    the streaming route in turns;
12. K4 (the banded V-cycle: T1 and T2 as K2's level passes around K2's
    cycle from level 1, one C entry) against its plain version on the card,
    bit for bit, in 2 + the tail's launches: B=2 at 2048^2 and at 2007x1002
    (padded to 2048x1024) in fp32, B=2 at 256x320 in fp64; the device time
    of T1, the tail and T2;
13. K5 (the banded CG steps, three tile passes an iteration) against its
    plain version on the card, B=4 x 2048^2, k=5, stored and matrix-free,
    with a frozen image, one that exits at iteration 0 and one tripped by
    its divergence threshold, bit for bit;
14. BASELINE config 3 (one 2048^2 image, contrast 1e-6, fp32, relresidual
    1e-4) through ``solve_mgcg`` with the engine left to the auto rule,
    stored and matrix-free, each against the same solve on the plain
    versions, then one warm-up and three timed solves per leg;
15. the CLI route to the banded engine: ``single_sim`` with ``Solver:
    mgcg`` on the config-3 image, and ``batch_sim`` on two 2048^2 images
    with ``Pallas: auto`` (K4/K5) and ``Pallas: force`` (K1/K2); then the
    force batch in float64 through "cgstep" (K1/K2) and "tiled" (K4/K5);
16. K4/K5 times (CUDA events) at B=1 and B=4 x 2048^2 fp32, K4's device
    time by launch (T1, the tail, T2), K5's launches an iteration, its
    reckoned bytes a cell an iteration and the bounds (level 0 counted in
    every pass that must read it);
17. one config-3 solve per leg under ``torch.profiler``: device busy time,
    the span of its kernels and the idle share, and device time by kernel
    group;
18. K6 (the 3D V-cycle) whole against its plain version on the card: B=2
    x 64^3 fp32 with nu=2, B=2 x 40x36x52 fp64 with nu=1 (bit for bit);
19. K6 banded against its plain version: B=1 x 256^3 fp32 nu=2, B=2 x
    100x64x90 fp32 (padded by ``pad_shape_3d``), B=1 x 48^3 fp64 nu=3;
20. K7 (the three z-marching passes of the 3D CG steps) against its plain
    version, B=4 x 256^3 fp32, k=5, stored and matrix-free, with a frozen
    volume, one that exits at iteration 0 and one tripped by its divergence
    threshold, bit for bit; then B=1 x 256^3 float64 at nu=3;
21. BASELINE config 5 (``benchmarks/bench3d.py``'s problem: one 256^3
    volume, contrast 1e-6, fp32, relresidual 1e-4, V(2,2)) through
    ``solve_mgcg_3d`` with the engine left to the auto rule, matrix-free
    and stored, each against the same solve on the plain versions, then
    one warm-up and three timed solves per leg; the K7 iterations launched
    (at most one a window past the last live one) and the 3D cycles;
22. the CLI route: an ``input.txt`` with ``InputName: vol.npy`` (the
    config-5 medium) through ``cli.main`` into ``volume_sim``, against the
    direct solve with the same settings; the 2- and 3-phase parallel slabs
    against their analytic Deff; ``RunBatch: 1`` on ``ImageDir/00000.npy``
    ... ``00003.npy`` (4 x 64^3) against the four single solves;
23. K6/K7 times (CUDA events) at B=1 and B=4 x 256^3 fp32, stored and
    matrix-free, with K7's launches an iteration, its reckoned bytes a cell
    an iteration and the bounds;
24. one config-5 solve per leg under ``torch.profiler``;
25. K8 (the row-sharded cycle: T1/T2 on every shard of the row in one
    launch a leg, neighbours read in place, around the gathered K2 tail
    restricted into in place) against its plain version on the card, bit
    for bit, one application of ``v_cycle_sharded_fused``: config 3's
    2048^2 fp32 at SP=4 on four shards of ``cuda:0``, B=2; the same at SP=1;
    4096^2 at SP=4 (a sharded level 1 too); B=2 x 256x320 fp64 at SP=4;
    its launches (2 a fused level plus the tail's), no strip exchanged, and
    an application's wall time beside K8's own device time;
26. K9 (the sharded CG steps: three passes an iteration, each one launch
    for the row's shards, neighbours and the gathered tail's plane read in
    place) against its plain version, bit for bit, B=4 x 2048^2, SP=4,
    k=5, with a frozen image, one that exits at iteration 0 and one
    tripped by its divergence threshold; no strip exchanged and no coarse
    plane gathered or split in its window, its graph replays within the
    live iterations and WINDOW_LAG; its graph route (the shards on one
    card) against its host loop, bit for bit;
27. BASELINE config 3's image (phase 14's problem) through
    ``sharded_solve_mgcg`` on four shards of the card and on one, each
    against the same solve on the plain versions and against phase 14's
    unsharded stored solve, with the device count of its K2 image cycles
    equal to the live iterations plus the fresh and refresh cycles and the
    SP=4 solve timed on the graph route and the host loop in turns, K9's
    graph replays within the live iterations and WINDOW_LAG a window, and
    no strip exchange and no coarse gather or split in K9's windows, then
    config 3's generator at 4096^2 at SP=4:
    one float32 solve of the sharded and the unsharded banded engine (the
    float32 relres floor lies above 1e-4 there), and a float64 leg against
    the unsharded banded solve; one warm-up and three timed solves a leg,
    peak memory;
28. the pipeline routes: ``batch_sim`` with ``Devices: 4, DP: 1, SP: 4``
    (mgcg) on two 2048^2 images against ``Devices: 1``, ``Devices: 2, DP:
    2`` on phase 10's 64 images against phase 10's table, and the dry-run
    twin (``parallel/dryrun.py``) on four shards;
29. K8/K9 times (CUDA events; K8's own device time beside the
    application's, K9's passes' device times) at B=1 and B=4 x 2048^2,
    SP=4 and SP=1 (K9 on the graph route and the host loop in turns), then
    one sharded config-3 solve under ``torch.profiler``;
30. BASELINE config 3's ``cg`` leg (bench_configs.py: 2048^2 fp32,
    Jacobi-PCG to relresidual 1e-8 within 20000 iterations, a check every
    500): iterations, relres, seconds and windows; finite, no divergence,
    relres below the first check's;
31. BASELINE config 2 (512^2, per-pixel D log-uniform over 3 decades,
    fp32) through ``solve_rbsor`` on the reference protocol (deff 1e-5, a
    check every 10000 sweeps): sweeps, Deff, seconds, Gcell-iters/s; Deff
    within 1e-3 of a scipy float64 direct solve;
32. config 3's f64 ``dmg`` leg (no deflation, relres 1e-8 within 600
    iterations) on K4, the route the auto rule takes at 2048^2, best of 3
    after a warm-up, K4's launches a solve and a profile; then at 1024^2
    on K2 (forced); each against the same solve on the plain versions
    (iterations within 2, Deff rtol 1e-6);
33. the reference demo's setting (a synthetic 2007x1002 3-phase lossless
    PNG, Dg 1237500, float64, dmg, relres 1e-10) through ``python -m
    effectivediffusivityfvm_tpu_torch.cli`` and through ``cli.main`` to
    read the field: components, iterations, relres (<= 1e-10) and the
    boundary Deff against ``deff_flux_average`` (within 1e-4);
34. four 256^2 3-phase images through ``batch_sim_3phase`` with dcg,
    cgir and dmg, each against its single-image solves (rtol 1e-8), and
    dmg on ``Devices: 2``, ``DP: 2`` (cuda:0 twice) against the batch;
35. config 5's 256^3 volume through ``solve_cg_3d`` (2000 iterations at
    most, a check every 100), then a 64^3 slice of it through ``.npy`` CLI
    runs with rbsor and cg, whose Deff agree to 1e-3;
36. 3D ``dmg`` (``solve_dmg_3d``, f64, its f32 cycle on K6's banded route
    at 256^3): config 5's medium with gas balls through both Dirichlet
    faces, Dg 1000, against the same solve on the plain versions
    (iterations within 2, Deff rtol 1e-6), relres <= 1e-10 or the cap, a
    profile; then the volume as ``.npy`` through the CLI (``Phases: 3``,
    ``Solver: dmg``);
37. ``Compact: 1``: BASELINE config 4 (512^2, B=256) through
    ``solve_mgcg_batched`` and ``solve_batched_compacted`` (segment 50),
    every image conv <= 1e-6, Deff within 1e-4 of the unsegmented batch,
    the segments and sub-batch sizes, K1/K2 launches; then through
    ``batch_sim`` in float64 with ``Compact: 0`` and ``1``, every image
    conv <= 1e-6, Deff within 1e-4;
38. the sharded MGCG routes under ``run_pcg``: config 3's generator at
    2044x2048 on four shards of the card (511-row shards: the cycle-only
    route, K2 on the gathered image, in fp32 and f64; ``use_pallas=False``
    in f64) and a log-uniform 24x96 f64 medium (6-row shards), each
    against its
    plain-version run (iterations within 2, rtol 1e-6) and, in f64, the
    unsharded ``solve_mgcg`` (rtol 1e-3);
39. the z-slab sharded 3D solvers: config 5 at SP=4 on the card through
    ``sharded_solve_mgcg_3d`` (its tail on K6; f64 to relres 1e-6)
    against its plain version, the same solve on one slab (iterations
    within 2, rtol 1e-4: its tail starts lower) and ``solve_mgcg_3d``
    (rtol 1e-4), through
    ``sharded_solve_jacobi_3d`` (300 sweeps, fp32) and
    ``sharded_solve_cg_3d`` (200 iterations, f64) against the unsharded
    solvers (rtol 1e-6), and the dry-run twin's 3D leg;
40. native preprocessing: the library builds; the flood fill of config
    3's 2048^2 image and of 256 x 128^2 images equal to the scipy route's
    and to ``participating_mask_device`` on the card; their times;
41. the differentiable Deff (``ops/autodiff.py``): ``deff_and_grad`` on 8
    of phase 5's images in float64 (relres 1e-10, a check every 500,
    V(2,2)), forward and adjoint solves on K1/K2: forward and backward
    times (best of 3 after a warm-up), their ratio, the iterations and
    the launches of each pass; the same call on the plain versions,
    converged (iterations within 10% + 2, Deff 1e-8, gradient within 1e-5
    of max|g|: this ill-conditioned medium's solve moves that much under
    another order of the sums) and at a fixed budget of 10 iterations
    (gradient within 1e-9 of max|g|); central differences
    on image 0's four fluid cells of the largest |grad| (eps 1e-5 d;
    the gradient and the differences from solves of a fixed 600
    iterations; 1e-5 relative); a uniform 512^2 medium (Deff 2.5 to
    1e-9, the gradient summing to 1 to 1e-6); then config 3's 2048^2 image
    in float32 at relres 1e-6 (at most 100 iterations) on K4/K5 against
    its plain route (iterations within 2, gradient within 1e-5 of
    max|g|) and, ungated, against the float64 gradient (K1/K2);
42. the other modules: ``checkpointed_solve`` of ``solve_mgcg`` on one
    512^2 image in segments of 20 iterations (K1/K2) against the
    unsegmented solve (Deff 1e-6) and resumed from its file at once; the
    protocol carry of ``solve_jacobi`` on a 128^2 image, stopping at the
    continuous run's sweep with Deff and field equal; ``AsyncSaver``;
    ``trace()`` of a slice solve naming K1's and K2's kernels;
    ``benchmark_solver`` on it beside phase 5's time; ``nan_guard`` on a
    CUDA NaN; ``read_cmap`` of the CMAP ``single_sim`` wrote; ``entry()``
    on the card against ``entry(device="cpu")`` (rtol 1e-5);
43. config 3's image on the engines under ``run_pcg``: the cycle-only PCG
    on K2 (``use_pallas=True``) and on K4 (``"tiledcycle"``) in float32
    against their plain-version runs (iterations within 2, Deff rtol
    1e-6), the plain torch cycle (``use_pallas=False``) in float32
    (reported), and in float64 (150 iterations) with V(2,2) and, by the
    auto rule, V(2,1), against the fused "cgstep" float64 solve (Deff rtol
    1e-6 and 1e-4);
44. config 5 on the plain 3D cycle with V(2,2) and V(2,1) (at most 60
    iterations; Deff rtol 5e-3 against the fused solve where relres 1e-4
    is reached); config 3 in float64 at SP=4 on the card with V(2,1)
    against the unsharded solve (iterations within 2, Deff 1e-3);
    ``solve_dmg(use_pallas=False)`` on phase 32's float64 leg against its
    K4 run (Deff 1e-4), and ``solve_dmg_3d`` on phase 36's volume, the
    plain cycle at nu = 3 against K6 (Deff and relres 1e-6) and at nu = 4
    (relres within 1.2 of nu = 3's), all capped;
45. phase 10's mgcg CLI batch input with ``Pallas: interpret`` (Deff
    within 1e-4 of phase 10's) and ``Pallas: off`` (equal to a direct
    ``use_pallas=False`` solve, within 0.1 of phase 10's).

The last lines are a JSON object describing the kernels, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH, SIZE = 512, 512
POROSITY, CONTRAST = 0.65, 1e-6
SOLVE_KW = dict(tol=1e-6, max_iter=3000, check_every=40,
                criterion="residual", min_size=8, coarse_iters=8, nu1=2,
                nu2=2, over=1.8, mg_omega=(1.281, 0.5584), first_window=40)
MG = dict(omega=SOLVE_KW["mg_omega"], nu=2, coarse_iters=8, over=1.8)
JAC_BATCH, JAC_SIZE = 256, 128        # phase 8: the datagen batch
JAC_TOL, JAC_MAX = 1e-5, 500_000      # the reference protocol
JAC_CAP = 20_001                      # re-solve cap against the plain version
K3_TIME_K = 1000                      # sweeps per timed K3 call
# BASELINE config 3 (benchmarks/bench_configs.py: 2048^2, rng seed 3,
# porosity 0.65, sigma 8, D = 1 on pixels 0 and 1e-6 elsewhere)
C3_SIZE, C3_SEED, C3_SIGMA = 2048, 3, 8.0
C3_KW = dict(tol=1e-4, max_iter=400, check_every=10, criterion="relresidual",
             min_size=32, coarse_iters=64, nu1=2, nu2=2, over=1.8,
             mg_omega=0.8)
MG3 = dict(omega=0.8, nu=2, coarse_iters=64, over=1.8)
C15_TOL = 1e-7                        # mean|r| for the CLI runs (~relres 2e-4)
K5_TIME_K = 10                        # iterations per timed K5 call
# BASELINE config 5 (benchmarks/bench3d.py: 256^3, rng seed 11, sigma 3,
# porosity 0.65, D = 1 on fluid and 1e-6 elsewhere, fp32, x0 linear in x)
C5_SIZE, C5_SEED, C5_SIGMA = 256, 11, 3.0
C5_KW = dict(tol=1e-4, max_iter=2000, check_every=10,
             criterion="relresidual", nu1=2, nu2=2, mg_omega=0.8,
             coarse_iters=8, min_size=4, over=1.8, first_window=0)
MG5 = dict(omega=0.8, nu=2, coarse_iters=8, over=1.8)
C5_JAX_ITERS = 10                     # docs/PERFORMANCE.md:66 (algorithmic)
K7_TIME_K = 5                         # iterations per timed K7 call

# Least-time reckoning (bound_ms): the larger of the bytes a call must move
# (each input read once, each output written once) over the card's memory
# rate and its operations over the peak rate for their type (H100 SXM:
# 3.35 TB/s; 67 TFLOP/s fp32 and 34 TFLOP/s fp64 outside the tensor cores).
HBM_BPS = 3.35e12
PEAK_OPS = {4: 67e12, 8: 34e12}       # by element size
WORK_DIR = Path(__file__).resolve().parent / "build" / "smoke"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_images(batch, ny, nx=None, seed=7):
    """bench.py's generator: Gaussian-smoothed noise (sigma 4) thresholded at
    the porosity quantile; pixels above it are solid (255)."""
    from scipy import ndimage

    nx = ny if nx is None else nx
    rng = np.random.default_rng(seed)
    imgs = np.empty((batch, ny, nx), np.uint8)
    for i in range(batch):
        noise = ndimage.gaussian_filter(rng.standard_normal((ny, nx)),
                                        sigma=4.0)
        imgs[i] = (noise >= np.quantile(noise, POROSITY)) * 255
    return imgs


def correlated_binary(rng, ny, nx, porosity=POROSITY, sigma=C3_SIGMA):
    """bench_configs.py's config-3 generator, for any shape: Gaussian-
    smoothed noise thresholded at the porosity quantile, solid = 255."""
    from scipy import ndimage

    noise = ndimage.gaussian_filter(rng.standard_normal((ny, nx)),
                                    sigma=sigma)
    return ((noise >= np.quantile(noise, porosity)) * 255).astype(np.uint8)


def build_problem(imgs, dev, dtype=None):
    import torch

    from effectivediffusivityfvm_tpu_torch.models import phases
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec

    dtype = dtype or torch.float32
    classes = phases.two_phase_classes(imgs)
    d = torch.tensor(phases.d_field_from_classes(classes, 1.0, CONTRAST),
                     dtype=dtype, device=dev)
    coeffs = fvm.fvm_coefficients(d, 0.0, 1.0)
    spec = make_flux_spec(d, 0.0, 1.0)
    nx = imgs.shape[-1]
    x0 = (torch.arange(nx, dtype=dtype, device=dev) / nx).expand(imgs.shape)
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


def device_ms(fn, reps):
    """Mean milliseconds of device time per call of ``fn`` over ``reps``
    calls under ``torch.profiler`` (its kernels' and copies' durations
    summed: the call's time with the host's gaps taken out), or None where
    the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / reps


def launch_us(fn, reps, ordered=True):
    """The device time of each kernel ``fn`` launches, in launch order:
    ``[(name, mean microseconds)]`` over ``reps`` calls under
    ``torch.profiler`` (every call launching the same kernels), or None
    where the profiler saw no device activity or another count of kernels.
    ``ordered=False``: each distinct kernel (full name) with its summed
    time a call instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # kernels only: the profiler also books its own buffer requests and
    # the copies on the device
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "kernel" in e.name.lower()),
                 key=lambda e: e.time_range.start)
    if not ordered:
        # each kernel (full name) with its mean time a call, in the order of
        # its first launch
        tot = {}
        for e in dev:
            tot[e.name] = tot.get(e.name, 0.0) + e.time_range.elapsed_us()
        return [(n, t / reps) for n, t in tot.items()] or None
    if not dev or len(dev) % reps:
        return None
    n = len(dev) // reps
    out = []
    for k in range(n):
        name = dev[k].name.split("<")[0].split("::")[-1]
        out.append((name, sum(dev[i * n + k].time_range.elapsed_us()
                              for i in range(reps)) / reps))
    return out


def k4_split(fn, reps):
    """K4's device time by launch, from its kernels' names: ``(T1, the K2
    tail's launches, T2)`` in microseconds a call, and the tail's kernels;
    None where not measured."""
    us = launch_us(fn, reps, ordered=False)
    if not us:
        return None

    def banded(n, leg):
        return "BandedLeg>" in n and leg in n

    t1 = sum(t for n, t in us if banded(n, "level_down") or "tiled_pre" in n)
    t2 = sum(t for n, t in us if banded(n, "level_up") or "tiled_post" in n)
    tail = [(n.split("<")[0].split("::")[-1], t) for n, t in us
            if any(f in n for f in K2_KERNELS) and "BandedLeg>" not in n]
    return (t1, sum(t for _, t in tail), t2,
            [f"{n} {t:.1f}" for n, t in tail])


def k4_split_text(split):
    if split is None:
        return "by launch not measured"
    t1, tail, t2, parts = split
    return (f"by launch T1 {t1:.1f} us, K2 tail {tail:.1f} us "
            f"({', '.join(parts)}), T2 {t2:.1f} us")


def kernel_device_us(fn, reps, frags):
    """Mean device microseconds a call of ``fn`` spends in kernels whose
    names hold one of ``frags``, and in all its kernels and copies:
    ``(own, all)``, or None where the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    own = sum(e.time_range.elapsed_us() for e in dev
              if any(f in e.name for f in frags))
    return own / reps, sum(e.time_range.elapsed_us() for e in dev) / reps


def bound(nbytes, ops, itemsize):
    """``(bound_ms, bound_by)`` of a call moving ``nbytes`` and doing
    ``ops`` operations."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cycle_work(levels, bsz, itemsize, nu):
    """Bytes and operations of one V(nu, nu) cycle: reads a_w, a_n and
    diag_inv of every level and r, writes z; per cell of a level 5 + 24 nu
    operations (first pre-smooth 2, each further sweep 12, residual and
    restriction 13, prolongation 2, post-sweeps 12 each)."""
    cells = [c.diag.shape[-2] * c.diag.shape[-1] for c in levels]
    nbytes = itemsize * bsz * (3 * sum(cells) + 2 * cells[0])
    ops = bsz * (5 + 24 * nu) * sum(cells)
    return nbytes, ops, cells


def k1_bytes_per_cell(levels, itemsize, nu):
    """Reckoned bytes a K1 iteration moves per level-0 cell, ``(with
    per-sweep K2 levels, now)``, from the kernels' loads and stores (each
    plane a pass reads or writes counted once; a quarter plane for a
    restricted residual or a coarse correction).  Level 0, both: pass P 7 planes, pass X 10.25, pass
    Z 6.25: 23.5.  K2's levels from 1, one global pass a sweep (before):
    pre_first 5, 6 for each further pre-sweep, the residual and restriction
    5.25, post_first 6.25, 6 for each further post-sweep; the coarsest 5.
    Now: a DOWN pass (r and three coefficient planes read, e and a quarter
    plane written: 5.25) and an UP pass (e, r, the coefficients and a
    quarter plane read, the correction written: 6.25) for each level above
    the resident bottom; the bottom reads the three coefficient planes of
    its levels and its first level's right-hand side and writes that level's
    correction."""
    shapes = [tuple(c.diag.shape[-2:]) for c in levels]
    cells = [h * w for h, w in shapes]
    if len(cells) == 1:
        return (itemsize * 23.5,) * 2
    per_level = 5 + 6 * (nu - 2 if nu > 2 else 0) + 5.25 + 6.25 + 6 * (nu - 1)
    old = sum(per_level * n for n in cells[1:-1]) + 5 * cells[-1]
    new = k2_tail_cells(shapes, itemsize)
    return (itemsize * (23.5 + old / cells[0]),
            itemsize * (23.5 + new / cells[0]))


def k2_tail_cells(shapes, itemsize):
    """Reckoned elements K2's cycle moves from level 1 of the 2D hierarchy
    ``shapes`` down (K1's and K5's coarse tail): a DOWN pass (r and three
    coefficient planes read, e and a quarter plane written: 5.25 planes) and
    an UP pass (e, r, the coefficients and a quarter plane read, the
    correction written: 6.25) for each level above the resident bottom; the
    bottom reads the three coefficient planes of its levels and its first
    level's right-hand side and writes that level's correction."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import \
        cycle_resident_from

    cells = [h * w for h, w in shapes]
    lb = max(1, cycle_resident_from(shapes, itemsize))
    new = 11.5 * sum(cells[1:min(lb, len(cells) - 1)])
    return new + (3 * sum(cells[lb:]) + 2 * cells[lb] if lb < len(cells)
                  else 5 * cells[-1])


def k5_bytes_per_cell(levels, itemsize, mf=False):
    """Reckoned bytes a K5 iteration moves per level-0 cell, from the
    kernels' loads and stores (each plane a pass reads or writes counted
    once; a quarter plane for the restricted residual and the coarse
    correction).  Level 0 stored: pass P 7 planes (z, p_old, a_w, a_n,
    diag_inv in; p, q out), pass X 10.25 (r, q, x, p and the coefficients
    in; x, r, e and a quarter plane out), pass Z 6.25 (e, r, the
    coefficients and a quarter plane in; z out): 23.5.  Matrix-free the
    three coefficient planes of each pass become one D plane: 17.5.  Plus
    K2's cycle on levels[1:] (k2_tail_cells)."""
    shapes = [tuple(c.diag.shape[-2:]) for c in levels]
    return itemsize * ((17.5 if mf else 23.5)
                       + k2_tail_cells(shapes, itemsize) / (shapes[0][0]
                                                            * shapes[0][1]))


def phase(n, t0, text):
    print(f"phase {n} {text} [{time.perf_counter() - t0:.1f} s]", flush=True)

def c3_problem(imgs, dev, dtype=None):
    """Config 3's system for pixel arrays ``(..., ny, nx)``: D, coefficients,
    flux spec and the linear x0."""
    import torch

    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec

    dtype = dtype or torch.float32
    d = torch.tensor(np.where(imgs == 0, 1.0, CONTRAST), dtype=dtype,
                     device=dev)
    nx = imgs.shape[-1]
    x0 = (torch.arange(nx, dtype=dtype, device=dev) / nx).expand(imgs.shape)
    return (d, fvm.fvm_coefficients(d, 0.0, 1.0),
            make_flux_spec(d, 0.0, 1.0), x0)


def force_leg(imgs2, dtype, engine):
    """Phase 15's ``Pallas: force`` batch (two 2048^2 images, the pipeline's
    V(1,1) settings, mean|r| <= C15_TOL, MaxIter 400) with ``Dtype:
    dtype``, solved by ``engine`` ("cgstep": K1/K2, what force selects;
    "tiled": K4/K5).  Returns Deff, conv and iterations per image and the
    group's solve seconds."""
    import torch

    from effectivediffusivityfvm_tpu_torch.config import parse_input_file
    from effectivediffusivityfvm_tpu_torch.pipeline import batch

    WORK_DIR.mkdir(parents=True, exist_ok=True)
    csv = WORK_DIR / f"batch_c3_force_{dtype}_{engine}.csv"
    csv.unlink(missing_ok=True)
    inp = WORK_DIR / f"input_c3_force_{dtype}_{engine}.txt"
    inp.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: 2\n"
                   f"Ds: {CONTRAST}\nDf: 1\nSolver: mgcg\n"
                   f"Criterion: residual\nConvergence: {C15_TOL}\n"
                   f"MaxIter: 400\nPallas: force\nDtype: {dtype}\n"
                   f"OutputName: {csv}\n")
    groups = []
    solve_group, kwargs = batch.solve_image_group, batch._solver_kwargs

    def observed(*a, **kw):
        out = solve_group(*a, **kw)
        groups.append(out)
        return out

    def pinned(cfg, tol, max_iter):
        return dict(kwargs(cfg, tol, max_iter), use_pallas=engine)

    batch.solve_image_group, batch._solver_kwargs = observed, pinned
    try:
        table = batch.batch_sim(parse_input_file(str(inp)), imgs=list(imgs2),
                                device="cuda")
        torch.cuda.synchronize()
    finally:
        batch.solve_image_group, batch._solver_kwargs = solve_group, kwargs
    return table[:, 3], table[:, 6], np.asarray(groups[0][2]), groups[0][4]


def tiled_setup(d, coeffs, x0, min_size):
    """The banded engine's hierarchy and matrix-free arguments (as the
    solver builds them) and x0 padded to level 0."""
    import torch.nn.functional as F

    from effectivediffusivityfvm_tpu_torch.solvers import multigrid

    levels, mf = multigrid.tiled_system(coeffs, d, min_size=min_size)
    py, px = levels[0].diag.shape[-2:]
    x = F.pad(x0, (0, px - x0.shape[-1], 0, py - x0.shape[-2])).contiguous()
    return levels, x, mf


def tiled_work(levels, bsz, itemsize, nu, k=None, mf=False):
    """``(bytes, operations, bytes with level 0 read once a call)`` of one banded
    cycle (``k=None``: K4) or of a K5 call of ``k`` iterations with every
    image live.  Operations: the cycle's reckoning (cycle_work), and for K5
    per iteration 22 a cell for the CG updates, products and sums and, when
    matrix-free, 25 a cell in each of the three passes to rebuild the
    coefficients.  Bytes: level 0's working set is larger than L2 at the
    main path's sizes (a 2048^2 fp32 plane is 16.8 MB, seven or more of them
    live), so level 0 counts in every pass that must read it.  K4: T1 and T2
    each read r and the three coefficient planes, and z is written (9
    planes); e, which crosses the coarse tail from T1 to T2, counts no more
    than it does in K5 (T2 could rebuild it from r and the coefficients), so
    its round trip is a cost of the design, not of the function.  K5, each
    iteration: x, r, p, z and the coefficient planes (one D plane when
    matrix-free) read once and x, r, p, z written once.  Both plus K2's
    cycle on levels[1:] once a cycle (cycle_work).  The earlier reckoning
    read level 0 once a call."""
    once, ops, cells = cycle_work(levels, bsz, itemsize, nu)
    tail = cycle_work(levels[1:], bsz, itemsize, nu)[0]
    n0 = bsz * cells[0]
    if k is None:
        return itemsize * n0 * 9 + tail, ops, once
    old = once + itemsize * n0 * (6 - 2 - (2 if mf else 0))
    per_iter = itemsize * n0 * (8 + (1 if mf else 3)) + tail
    return (k * per_iter, k * (ops + n0 * (22 + (75 if mf else 0))), old)


# K2's kernels (csrc/vcycle.cu; the last three run in K1 at level 0 when
# nu > 2)
K2_KERNELS = ("level_down", "level_up", "bottom_kernel", "coarse_solve",
              "smooth_kernel", "resid_restrict", "post_first")
# kernel-name fragments -> the group a profile reports them under
PROFILE_GROUPS = (
    ("K5 pass P", "tile_p_kernel"), ("K5 pass X", "tile_x_kernel"),
    ("K5 pass Z", "tile_z_kernel"),
    ("K5 scalars", ("fin_", "abs_parts", "pin_kernel", "copy_back")),
    ("K4 T1/T2", ("BandedLeg",)),
    ("K2 levels", K2_KERNELS),
)
PROFILE_GROUPS_K1 = (
    ("K1 pass P", "pass_p_kernel"), ("K1 pass X", "pass_x_kernel"),
    ("K1 pass Z", "pass_z_kernel"), ("K1 scalars", ("fin_", "set_act")),
    ("K2 levels", K2_KERNELS),
    ("memset", ("emset",)),
)
PROFILE_GROUPS_K3 = (("K3 resident", "jacobi_resident"),
                     ("K3 streaming", "jacobi_sweep_kernel"))


def profile_line(prof):
    """One line of :func:`profile_solve`'s result."""
    if prof is None:
        return "the profiler saw no device activity"
    busy, span, wall, groups = prof
    return (f"busy {busy:.3f} ms of a {span:.3f} ms span (wall {wall:.3f} "
            f"ms), idle share {1 - busy / span:.1%}; " + ", ".join(
                f"{g} {ms:.3f} ms ({ms / busy:.1%})" for g, ms in sorted(
                    groups.items(), key=lambda kv: -kv[1])))


def profile_solve(fn, group_table=PROFILE_GROUPS):
    """Run ``fn`` once under ``torch.profiler``; returns ``(busy_ms,
    span_ms, wall_ms, groups)`` with the device time of every kernel and
    copy summed by ``group_table`` (the rest: "torch ops"), or None where
    the profiler saw no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev)) / 1e3
    groups = {}
    for e in dev:
        name = next((g for g, frag in group_table
                     if any(f in e.name for f in (
                         frag if isinstance(frag, tuple) else (frag,)))),
                    "torch ops")
        groups[name] = groups.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return busy, span, wall_ms, groups


def large_grid_phases(dev, card, lib):
    """Phases 12-16 (the banded engine); returns the rows of the kernels'
    JSON line for K4 and K5."""
    import torch

    from effectivediffusivityfvm_tpu_torch.config import (SimulationConfig,
                                                          parse_input_file)
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
        batch_sum, cg_steps)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import (
        cg_steps_tiled, cg_steps_tiled_reference)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import (
        cycle_launches, v_cycle)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_tiled import (
        v_cycle_tiled, v_cycle_tiled_reference)
    from effectivediffusivityfvm_tpu_torch.pipeline import batch, single
    from effectivediffusivityfvm_tpu_torch.solvers import multigrid

    wrappers = (v_cycle_tiled, cg_steps_tiled, v_cycle, cg_steps)

    def zero_counts():
        for w in wrappers:
            w.launches = 0
        return lib.deff_cycle_count()

    def counts(cyc0):
        return {"K4": v_cycle_tiled.launches, "K5": cg_steps_tiled.launches,
                "K2": v_cycle.launches, "K1": cg_steps.launches,
                "K2 cycles in the library": lib.deff_cycle_count() - cyc0}

    # -- 12: K4 against its plain version
    t0 = time.perf_counter()
    k4_err, lines = 0.0, []
    for ny, nx, dtype, seed in ((C3_SIZE, C3_SIZE, torch.float32, 3),
                                (2007, 1002, torch.float32, 4),
                                (256, 320, torch.float64, 5)):
        rng = np.random.default_rng(seed)
        imgs = np.stack([correlated_binary(rng, ny, nx) for _ in range(2)])
        d, c, _, x0 = c3_problem(imgs, dev, dtype)
        levels, x, _ = tiled_setup(d, c, x0, 32)
        r = levels[0].b - fvm.apply_operator(levels[0], x)
        n_k4, n_k2, n_lib = (v_cycle_tiled.launches, v_cycle.launches,
                             lib.deff_launch_count())
        z = v_cycle_tiled(levels, r, **MG3)
        torch.cuda.synchronize()
        n_k4, n_k2, n_lib = (v_cycle_tiled.launches - n_k4,
                             v_cycle.launches - n_k2,
                             lib.deff_launch_count() - n_lib)
        shapes = [tuple(cl.diag.shape[-2:]) for cl in levels]
        want = 2 + cycle_launches(shapes, r.element_size(), 1)
        check(n_k4 == 1 and n_k2 == 0 and n_lib == want,
              f"K4 calls {n_k4}, K2 calls {n_k2}, library launches {n_lib} "
              f"(T1, T2 and {want - 2} for K2's tail)")
        zp = v_cycle_tiled_reference(levels, r, **MG3)
        err = float((z - zp).abs().max())
        scale = float(zp.abs().max())
        check(torch.equal(z, zp), f"K4 {ny}x{nx}: max|z - z_plain| {err} "
              "(bit-equal expected)")
        k4_err = max(k4_err, err)
        split = k4_split(lambda: v_cycle_tiled(levels, r, **MG3), 3)
        lines.append(f"{ny}x{nx} {str(dtype)[-7:]} padded to "
                     f"{tuple(r.shape[-2:])}, {len(levels)} levels: max abs "
                     f"err {err:.3e} (max|z| {scale:.3e}), bit-equal True; "
                     f"{n_lib} library launches (T1, T2, {want - 2} for K2's "
                     f"tail), {k4_split_text(split)}")
        del d, c, levels, x, r, z, zp
    phase(12, t0, "K4 vs plain, B=2: " + "; ".join(lines))

    # -- 13: K5 against its plain version, B=4 x 2048^2, k=5
    t0 = time.perf_counter()
    rng = np.random.default_rng(C3_SEED)
    imgs4 = np.stack([correlated_binary(rng, C3_SIZE, C3_SIZE)
                      for _ in range(4)])
    d4, c4, _, x04 = c3_problem(imgs4, dev)
    levels4, x4, mf4 = tiled_setup(d4, c4, x04, C3_KW["min_size"])
    r4 = levels4[0].b - fvm.apply_operator(levels4[0], x4)
    p4 = v_cycle_tiled(levels4, r4, **MG3)
    rz = batch_sum(r4 * p4)
    sr0 = batch_sum(r4.abs())
    active = torch.ones(4, device=dev)
    active[1] = 0.0                              # frozen
    stop = torch.zeros(4, device=dev)
    stop[2] = 10.0 * sr0[2]                      # exits at iteration 0
    hi = torch.full((4,), float("inf"), device=dev)
    rz[3] *= 1e3                                 # overshoots ...
    hi[3] = 2.0 * sr0[3]                         # ... and trips its hi
    state = (x4, r4, p4, rz, active, stop, hi)
    k5_err, lines = 0.0, []
    for mode, extra in (("stored", {}), ("matrix-free", mf4)):
        got = cg_steps_tiled(levels4, *(t.clone() for t in state), 5, **MG3,
                             **extra)
        ref = cg_steps_tiled_reference(levels4, *(t.clone() for t in state),
                                       5, **MG3, **extra)
        torch.cuda.synchronize()
        kd = got[4].tolist()
        check(kd == ref[4].tolist(), f"K5 {mode} k_done {kd} != plain "
              f"{ref[4].tolist()}")
        check(kd[:3] == [5, 0, 0] and kd[3] >= 1, f"K5 {mode} k_done {kd}")
        err_m = 0.0
        for nm, g, e in zip("xrp", got[:3], ref[:3]):
            for b in range(4):
                err = float((g[b] - e[b]).abs().max())
                scale = float(e[b].abs().max())
                check(err <= 1e-4 * scale,
                      f"K5 {mode} {nm}[{b}] err {err} > 1e-4*{scale}")
                err_m = max(err_m, err)
        rz_err = float(((got[3] - ref[3]).abs() / ref[3].abs()).max())
        check(rz_err <= 1e-3, f"K5 {mode} rz rel err {rz_err}")
        # float32 products summed in double and rounded once: bit for bit
        bit = all(bool(torch.equal(g, e)) for g, e in zip(got[:4], ref[:4]))
        check(bit, f"K5 {mode}: x/r/p/rz not bit-equal to the plain "
              f"version (max abs err {err_m})")
        for g, e in zip(got[:4], ref[:4]):
            check(bool(torch.equal(g[1], e[1])), f"K5 {mode} frozen image")
        k5_err = max(k5_err, err_m)
        lines.append(f"{mode}: k_done {kd}, max abs err x/r/p {err_m:.3e}, "
                     f"rz max rel err {rz_err:.3e}, bit-equal {bit}")
    phase(13, t0, "K5 vs plain, B=4 x 2048^2, k=5: " + "; ".join(lines))
    del got, ref, state, levels4, x4, mf4, r4, p4

    # the float64 instantiation at nu = 3 on config 3's first image, B=1:
    # float64 products summed in another order than the plain version's
    # (torch.sum), so within 1e-9 of max|.|, not bit for bit
    t0 = time.perf_counter()
    d64, c64, _, x064 = c3_problem(imgs4[:1], dev, torch.float64)
    lv64, x64, mf64 = tiled_setup(d64, c64, x064, C3_KW["min_size"])
    r64 = lv64[0].b - fvm.apply_operator(lv64[0], x64)
    mg3 = dict(MG3, nu=3)
    p64 = v_cycle_tiled(lv64, r64, **mg3)
    one = torch.ones(1, dtype=torch.float64, device=dev)
    state = (x64, r64, p64, batch_sum(r64 * p64), one, 0 * one,
             one * float("inf"))
    lines = []
    for mode, extra in (("stored", {}), ("matrix-free", mf64)):
        got = cg_steps_tiled(lv64, *(t.clone() for t in state), 5, **mg3,
                             **extra)
        ref = cg_steps_tiled_reference(lv64, *(t.clone() for t in state), 5,
                                       **mg3, **extra)
        torch.cuda.synchronize()
        kd = got[4].tolist()
        check(kd == ref[4].tolist() == [5], f"K5 fp64 {mode} k_done {kd}")
        err_m = 0.0
        for nm, g, e in zip("xrp", got[:3], ref[:3]):
            err = float((g - e).abs().max())
            check(err <= 1e-9 * float(e.abs().max()),
                  f"K5 fp64 {mode} {nm} err {err}")
            err_m = max(err_m, err)
        rz_err = float(((got[3] - ref[3]).abs() / ref[3].abs()).max())
        check(rz_err <= 1e-9, f"K5 fp64 {mode} rz rel err {rz_err}")
        bit = all(bool(torch.equal(g, e)) for g, e in zip(got[:4], ref[:4]))
        lines.append(f"{mode}: k_done {kd}, max abs err x/r/p {err_m:.3e}, "
                     f"rz rel err {rz_err:.3e}, bit-equal {bit}")
        del got, ref
    phase(13, t0, "K5 vs plain, B=1 x 2048^2 fp64 nu=3, k=5: "
          + "; ".join(lines))
    del d64, c64, x064, lv64, x64, mf64, r64, p64, state

    # -- 14: BASELINE config 3 through solve_mgcg, engine by the auto rule
    t0 = time.perf_counter()
    check(multigrid._engine_auto(C3_SIZE, C3_SIZE, torch.float32) == "tiled",
          "the auto rule does not pick the banded engine at 2048^2 fp32")
    img3 = imgs4[0]
    d1, c1, s1, x01 = c3_problem(img3, dev)
    legs, main_launches, c3_ref = {}, None, {}
    for name, extra in (("stored", dict(first_window=0)),
                        ("matrix-free", dict(d_field=d1, first_window=1))):
        torch.cuda.synchronize()
        cyc0 = zero_counts()
        t1 = time.perf_counter()
        res = multigrid.solve_mgcg(c1, s1, x01, **C3_KW, **extra)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t1
        launched = counts(cyc0)
        if main_launches is None:
            main_launches = launched
        check(launched["K4"] > 0 and launched["K5"] > 0
              and launched["K2 cycles in the library"] > 0
              and launched["K1"] == 0, f"config 3 {name} launches {launched}")
        conv, deff, iters = float(res.conv), float(res.deff), int(res.iters)
        check(np.isfinite(deff) and conv <= C3_KW["tol"],
              f"config 3 {name}: relres {conv}, Deff {deff}")
        plain = multigrid._mgcg_core(c1, s1, x01, batched=False, plain=True,
                                     **C3_KW, **extra)
        p_deff, p_iters = float(plain.deff), int(plain.iters)
        rel = abs(deff - p_deff) / abs(p_deff)
        check(rel <= 1e-4 and abs(iters - p_iters) <= 2,
              f"config 3 {name} vs plain: Deff {deff} / {p_deff}, "
              f"iterations {iters} / {p_iters}")
        multigrid.solve_mgcg(c1, s1, x01, **C3_KW, **extra)     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            res = multigrid.solve_mgcg(c1, s1, x01, **C3_KW, **extra)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        legs[name] = deff
        c3_ref[name] = (deff, iters)
        phase(14, t0, f"BASELINE config 3 {name} {card}: 2048^2 fp32, "
              f"{iters} iterations (plain {p_iters}), relres {conv:.3e}, "
              f"Deff {deff:.6f} (plain {p_deff:.6f}, rel err {rel:.3e}), "
              f"first run {t_first:.4f} s, timed "
              f"{', '.join(f'{t:.4f}' for t in times)} s, "
              f"{min(times) / iters * 1e3:.4f} ms/iteration, peak memory "
              f"{peak / 2**30:.3f} GiB, launches {launched}")
        t0 = time.perf_counter()
        del res, plain
    rel_sm = abs(legs["stored"] - legs["matrix-free"]) / abs(legs["stored"])
    check(rel_sm <= 1e-3, f"stored vs matrix-free Deff rel err {rel_sm}")
    phase(14, t0, f"stored vs matrix-free Deff rel err {rel_sm:.3e}")

    # -- 15: the CLI route to the banded engine
    t0 = time.perf_counter()
    cyc0 = zero_counts()
    r15 = single.single_sim(
        SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=CONTRAST,
                         solver="mgcg", criterion="residual",
                         convergence=C15_TOL, max_iter=400),
        img=img3, write_output=False, device="cuda")
    torch.cuda.synchronize()
    l_single = counts(cyc0)
    check(l_single["K4"] > 0 and l_single["K5"] > 0 and l_single["K1"] == 0,
          f"single_sim mgcg launches {l_single}")
    check(np.isfinite(r15.deff) and 0 < r15.deff <= 1, f"Deff {r15.deff}")
    results = [f"single_sim Deff {r15.deff:.6f}, conv {r15.conv:.3e}, "
               f"{r15.iters} iterations, launches {l_single}"]
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    for mode, want, absent in (("auto", ("K4", "K5"), "K1"),
                               ("force", ("K1",), "K5")):
        csv = WORK_DIR / f"batch_c3_{mode}.csv"
        csv.unlink(missing_ok=True)
        inp = WORK_DIR / f"input_c3_{mode}.txt"
        inp.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: 2\n"
                       f"Ds: {CONTRAST}\nDf: 1\nSolver: mgcg\n"
                       f"Criterion: residual\nConvergence: {C15_TOL}\n"
                       f"MaxIter: 400\nPallas: {mode}\nOutputName: {csv}\n")
        cyc0 = zero_counts()
        table = batch.batch_sim(parse_input_file(str(inp)),
                                imgs=list(imgs4[:2]), device="cuda")
        torch.cuda.synchronize()
        launched = counts(cyc0)
        check(all(launched[k] > 0 for k in want) and launched[absent] == 0,
              f"batch_sim Pallas: {mode} launches {launched}")
        check(bool(np.all(np.isfinite(table[:, 3]))), "batch Deff not finite")
        results.append(f"batch_sim Pallas: {mode} Deff "
                       f"{', '.join(f'{v:.6f}' for v in table[:, 3])}, conv "
                       f"{table[:, 6].max():.3e}, solve "
                       f"{table[:, 4].sum():.3f} s, launches {launched}")
        force32 = table[:, 3]
    phase(15, t0, "CLI route: " + "; ".join(results))

    # the same force batch in float64 through K1/K2 and through K4/K5: where
    # both converge to one Deff, the float32 force result above is the
    # float32 floor of the reference engine, not a fault of the port
    t0 = time.perf_counter()
    f64 = {}
    for engine, want in (("cgstep", "K1"), ("tiled", "K5")):
        cyc0 = zero_counts()
        f64[engine] = force_leg(imgs4[:2], "float64", engine)
        launched = counts(cyc0)
        check(launched[want] > 0, f"float64 {engine} launches {launched}")
        deff, conv, _, _ = f64[engine]
        check(bool(np.all(np.isfinite(deff)) and np.all(conv <= C15_TOL)),
              f"float64 {engine}: Deff {deff}, conv {conv}")
    gap = np.abs(f64["cgstep"][0] - f64["tiled"][0]) / np.abs(f64["tiled"][0])
    check(bool(np.all(gap <= 1e-3)), f"float64 cgstep vs tiled Deff gap {gap}")
    off32 = np.abs(force32 - f64["tiled"][0]) / np.abs(f64["tiled"][0])
    phase(15, t0, f"Pallas: force in float64 {card}: " + "; ".join(
        f"{eng} Deff {', '.join(f'{v:.6f}' for v in dv)}, conv "
        f"{cv.max():.3e}, iterations {', '.join(str(int(i)) for i in it)}, "
        f"solve {dt:.3f} s" for eng, (dv, cv, it, dt) in f64.items())
        + f"; cgstep vs tiled Deff rel gap {gap.max():.3e}; the float32 "
        f"force Deff off the float64 one by "
        f"{', '.join(f'{v:.3e}' for v in off32)}")

    # -- 16: K4/K5 times (CUDA events)
    t0 = time.perf_counter()
    times, lines = {}, []
    for bsz in (1, 4):
        sub = slice(0, bsz)
        levels, x, mf = tiled_setup(d4[sub], type(c4)(*(a[sub] for a in c4)),
                                    x04[sub], C3_KW["min_size"])
        r = levels[0].b - fvm.apply_operator(levels[0], x)
        item = x.element_size()
        ms = cuda_ms(lambda: v_cycle_tiled(levels, r, **MG3), 10, warm=2)
        ms_p = cuda_ms(lambda: v_cycle_tiled_reference(levels, r, **MG3), 3)
        n0 = lib.deff_launch_count()
        v_cycle_tiled(levels, r, **MG3)
        per_cycle = lib.deff_launch_count() - n0
        work = tiled_work(levels, bsz, item, MG3["nu"])
        times[("K4", bsz)] = (ms, ms_p, bound(*work[:2], item))
        split = k4_split(lambda: v_cycle_tiled(levels, r, **MG3), 10)
        lines.append(f"B={bsz} K4 cycle {ms:.4f} ms (plain {ms_p:.4f} ms, "
                     f"bound {times[('K4', bsz)][2][0]:.4f} ms by "
                     f"{times[('K4', bsz)][2][1]}, level 0 read once "
                     f"{bound(work[2], work[1], item)[0]:.4f} ms; "
                     f"{per_cycle} launches; device {k4_split_text(split)})")
        p = v_cycle_tiled(levels, r, **MG3)
        rz = batch_sum(r * p)
        ones = torch.ones(bsz, device=dev)
        zero = torch.zeros(bsz, device=dev)
        inf = torch.full((bsz,), float("inf"), device=dev)
        for mode, extra in (("stored", {}), ("matrix-free", mf)):
            def k5(fn, k=K5_TIME_K, reps=4):
                states = [(x.clone(), r.clone(), p.clone())
                          for _ in range(reps)]
                return lambda: fn(levels, *states.pop(), rz, ones, zero, inf,
                                  k, **MG3, **extra)

            n0 = lib.deff_launch_count()
            k5(cg_steps_tiled, 0, 1)()
            n1 = lib.deff_launch_count()
            k5(cg_steps_tiled, K5_TIME_K, 1)()
            per_iter = (lib.deff_launch_count() - n1 - (n1 - n0)) / K5_TIME_K
            shapes = [tuple(c.diag.shape[-2:]) for c in levels]
            want = 5 + cycle_launches(shapes[1:], item)
            check(per_iter == want, f"K5 {per_iter} launches an iteration: "
                  f"three passes, two finalizes and {want - 5} for K2's tail")
            ms = cuda_ms(k5(cg_steps_tiled), 3)
            ms_p = cuda_ms(k5(cg_steps_tiled_reference, reps=2), 1)
            work = tiled_work(levels, bsz, item, MG3["nu"], K5_TIME_K,
                              mf=bool(extra))
            bd = bound(*work[:2], item)
            times[(mode, bsz)] = (ms, ms_p, bd)
            lines.append(f"B={bsz} K5 {mode} k={K5_TIME_K} {ms:.4f} ms "
                         f"({ms / K5_TIME_K:.4f} ms/iteration; plain "
                         f"{ms_p:.4f} ms, bound {bd[0]:.4f} ms by {bd[1]} "
                         f"(level 0 read once a call: "
                         f"{bound(work[2], work[1], item)[0]:.4f} ms), "
                         f"{per_iter:g} launches/iteration (three passes, "
                         f"two finalizes, {want - 5} for K2's tail), "
                         f"reckoned {k5_bytes_per_cell(levels, item, bool(extra)):.1f}"
                         f" B/cell an iteration)")
        del levels, x, mf, r, p
    phase(16, t0, f"K4/K5 times {card}, 2048^2 fp32: " + "; ".join(lines))

    # -- 17: one config-3 solve per leg under the profiler
    t0 = time.perf_counter()
    lines = []
    for name, extra in (("stored", dict(first_window=0)),
                        ("matrix-free", dict(d_field=d1, first_window=1))):
        prof = profile_solve(
            lambda: multigrid.solve_mgcg(c1, s1, x01, **C3_KW, **extra))
        if prof is None:
            lines.append(f"{name}: the profiler saw no device time")
            continue
        busy, span, wall, groups = prof
        lines.append(
            f"{name}: device busy {busy:.3f} ms of a {span:.3f} ms kernel "
            f"span (idle share {1 - busy / span:.1%}; wall {wall:.3f} ms "
            "under the profiler), by group " + ", ".join(
                f"{g} {ms:.3f} ms ({ms / busy:.0%})" for g, ms in
                sorted(groups.items(), key=lambda kv: -kv[1])))
    phase(17, t0, f"config 3 profile {card}: " + "; ".join(lines))

    k4_ms, k4_ms_p, k4_bound = times[("K4", 1)]
    k5_ms, k5_ms_p, k5_bound = times[("stored", 1)]
    return c3_ref, [
        {"name": "v_cycle_tiled", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/vcycle_tiled.cu",
         "replaces": "effectivediffusivityfvm_tpu/ops/kernels/vcycle_tiled.py:205",
         "launches": main_launches["K4"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_ms_p, "bound_ms": k4_bound[0],
         "bound_by": k4_bound[1], "library_ms": None},
        {"name": "cg_steps_tiled", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/cgstep_tiled.cu",
         "replaces": "effectivediffusivityfvm_tpu/ops/kernels/cgstep_tiled.py:386",
         "launches": main_launches["K5"], "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5_ms_p, "bound_ms": k5_bound[0],
         "bound_by": k5_bound[1], "library_ms": None},
    ]


# kernel-name fragments -> the group a 3D profile reports them under
PROFILE_GROUPS_3D = (
    ("K7 pass P", "march_p3_kernel"), ("K7 pass X", "march_x3_kernel"),
    ("K7 pass Z", "march_z3_kernel"),
    ("K6 DOWN passes (T1, tails)", "zdown3_kernel"),
    ("K6 UP passes (T2, tails)", "zup3_kernel"),
    ("K6 resident bottom (tails)", "bottom3_kernel"),
    ("3D coarsest level", "coarse_solve3_kernel"),
    ("K7 scalars", ("fin_", "abs_parts3", "pin_kernel", "copy_back")),
)


def c5_fluid(shape, seed, sigma=C5_SIGMA):
    """bench3d.py's config-5 medium, for any shape: Gaussian-smoothed noise
    (``default_rng(seed)``), fluid below the porosity quantile."""
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    noise = ndimage.gaussian_filter(rng.standard_normal(shape), sigma=sigma)
    return noise < np.quantile(noise, POROSITY)


def c5_problem(fluid, dev, dtype=None):
    """Config 5's system for fluid masks ``(..., nz, ny, nx)``: D (1 on
    fluid, CONTRAST elsewhere), coefficients, flux spec and the linear x0."""
    import torch

    from effectivediffusivityfvm_tpu_torch.ops import fvm3d

    dtype = dtype or torch.float32
    d = torch.tensor(np.where(fluid, 1.0, CONTRAST), dtype=dtype, device=dev)
    nx = fluid.shape[-1]
    x0 = (torch.arange(nx, dtype=dtype, device=dev) / nx).expand(fluid.shape)
    return (d, fvm3d.fvm_coefficients_3d(d, 0.0, 1.0),
            fvm3d.make_flux_spec_3d(d, 0.0, 1.0), x0)


def tiled3d_setup(d, coeffs, x0, min_size=4):
    """The banded 3D engine's hierarchy and matrix-free arguments (as the
    solver builds them), and x0 padded to level 0."""
    import torch.nn.functional as F

    from effectivediffusivityfvm_tpu_torch.solvers import solvers3d

    levels, mf = solvers3d.tiled3d_system(coeffs, d, min_size=min_size)
    pz, py, px = levels[0].diag.shape[-3:]
    nz, ny, nx = x0.shape[-3:]
    x = F.pad(x0, (0, px - nx, 0, py - ny, 0, pz - nz)).contiguous()
    return levels, x, mf


def cycle3_work(levels, bsz, itemsize, nu):
    """Bytes and operations of one 3D V(nu, nu) cycle: reads a_w, a_n, a_u
    and diag_inv of every level and r, writes z; per cell of a level
    4 + 32 nu operations (first pre-smooth 2, each further sweep 16,
    residual and restriction 16, prolongation 2, post-sweeps 16 each)."""
    cells = [c.diag[0].numel() for c in levels]
    nbytes = itemsize * bsz * (4 * sum(cells) + 2 * cells[0])
    ops = bsz * (4 + 32 * nu) * sum(cells)
    return nbytes, ops, cells


def banded3_work(levels, bsz, itemsize, nu):
    """``(bytes, operations, bytes with level 0 read once a call)`` of one banded 3D
    cycle (K6 banded): level 0's working set is larger than L2 at 256^3 (a
    fp32 volume is 67 MB), so T1 and T2 each read r and the four coefficient
    volumes, and z is written (11 volumes; e's round trip from T1 to T2 is
    a cost of the design, as in tiled_work), plus K6's whole cycle on
    levels[1:] (cycle3_work)."""
    once, ops, cells = cycle3_work(levels, bsz, itemsize, nu)
    tail = cycle3_work(levels[1:], bsz, itemsize, nu)[0]
    return itemsize * bsz * cells[0] * 11 + tail, ops, once


def cg3_work(levels, bsz, itemsize, nu, k, mf=False):
    """``(bytes, operations, bytes with level 0 read once a call)`` of a K7 call of
    ``k`` iterations with every volume live.  Operations: the cycle's
    reckoning per iteration, 40 a cell for the CG updates, products and
    sums and, when matrix-free, 30 a cell in each of the three passes to
    rebuild the coefficients.  Bytes, each iteration: x, r, p, z and the
    four coefficient volumes (one D volume when matrix-free) of level 0 read
    once and x, r, p, z written once (level 0's working set is larger than
    L2), plus K6's whole cycle on levels[1:].  The earlier reckoning read the
    hierarchy, x, r and p once a call."""
    once, ops, cells = cycle3_work(levels, bsz, itemsize, nu)
    tail = cycle3_work(levels[1:], bsz, itemsize, nu)[0]
    n0 = bsz * cells[0]
    old = once + itemsize * n0 * (6 - 2 - (3 if mf else 0))
    per_iter = itemsize * n0 * (8 + (1 if mf else 4)) + tail
    return (k * per_iter, k * (ops + n0 * (40 + (90 if mf else 0))), old)


def k6_tail_cells(shapes, itemsize):
    """Reckoned elements K6's whole cycle moves over the 3D levels
    ``shapes`` (csrc/vcycle3d.cu): a DOWN pass (r and the four coefficient
    volumes read, e and an eighth volume written: 6.125 volumes) and an UP
    pass (e, r, the coefficients and an eighth volume read, the correction
    written: 7.125) for each level above the resident bottom; the bottom
    reads the four coefficient volumes of its levels and its first level's
    right-hand side and writes that level's correction (when not even the
    coarsest level fits, its sweeps read its coefficients and right-hand
    side and write its correction: 6).  One global pass a stencil step
    moved 26.25 volumes a level at nu = 2."""
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle3d import \
        cycle3_resident_from

    cells = [a * b * c for a, b, c in shapes]
    lb = cycle3_resident_from(shapes, itemsize)
    passes = 13.25 * sum(cells[:min(lb, len(cells) - 1)])
    return passes + (4 * sum(cells[lb:]) + 2 * cells[lb] if lb < len(cells)
                     else 6 * cells[-1])


def k7_bytes_per_cell(levels, itemsize, mf=False):
    """Reckoned bytes a K7 iteration moves per level-0 cell, from the
    kernels' loads and stores (each volume a pass reads or writes counted
    once; an eighth volume for the restricted residual and the coarse
    correction).  Level 0 stored: pass P 8 volumes (z, p_old and the four
    coefficient volumes in; p, q out), pass X 11.125 (r, q, x, p and the
    coefficients in; x, r, e and an eighth out), pass Z 7.125 (e, r, the
    coefficients and an eighth in; z out): 26.25.  Matrix-free the four
    coefficient volumes of each pass become one D volume: 17.25.  Plus K6's
    whole cycle on levels[1:] (k6_tail_cells).  The eight launches of K7's
    first form moved ~42 volumes at level 0 (168 B/cell fp32, stored)."""
    shapes = [tuple(c.diag.shape[-3:]) for c in levels]
    n0 = shapes[0][0] * shapes[0][1] * shapes[0][2]
    return itemsize * ((17.25 if mf else 26.25)
                       + k6_tail_cells(shapes[1:], itemsize) / n0)


def volume_phases(dev, card, lib):
    """Phases 18-24 (the 3D voxel path); returns the rows of the kernels'
    JSON line for K6 (whole and banded) and K7."""
    import torch

    from effectivediffusivityfvm_tpu_torch import cli
    from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
    from effectivediffusivityfvm_tpu_torch.ops import fvm3d
    from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle3d as v3
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
        WINDOW_LAG, batch_sum)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep3d import (
        cg_steps3d, cg_steps3d_reference)
    from effectivediffusivityfvm_tpu_torch.pipeline import volume as pvol
    from effectivediffusivityfvm_tpu_torch.solvers import solvers3d

    wrappers = (v3.v_cycle3d, v3.v_cycle3d_tiled, cg_steps3d)

    def zero_counts():
        for w in wrappers:
            w.launches = 0
        return lib.deff_cycle3_count(), lib.deff_window_iter_count()

    def counts(c0):
        return {"K6 whole": v3.v_cycle3d.launches,
                "K6 banded": v3.v_cycle3d_tiled.launches,
                "K7": cg_steps3d.launches,
                "3D cycles in the library": lib.deff_cycle3_count() - c0[0],
                "K7 iterations launched":
                    lib.deff_window_iter_count() - c0[1]}

    def resid(levels, x):
        return levels[0].b - fvm3d.apply_operator_3d(levels[0], x)

    # -- 18: K6's whole cycle against its plain version
    t0 = time.perf_counter()
    k6w_err, lines = 0.0, []
    for shape, dtype, nu, seed in (((64, 64, 64), torch.float32, 2, 41),
                                   ((64, 64, 64), torch.float64, 3, 41),
                                   ((40, 36, 52), torch.float64, 1, 42)):
        fluid = np.stack([c5_fluid(shape, seed + 10 * i) for i in range(2)])
        d, c, _, x0 = c5_problem(fluid, dev, dtype)
        levels = solvers3d.build_hierarchy_3d(c, min_size=4, pad_levels=True)
        x = torch.nn.functional.pad(
            x0, (0, levels[0].diag.shape[-1] - shape[2],
                 0, levels[0].diag.shape[-2] - shape[1],
                 0, levels[0].diag.shape[-3] - shape[0])).contiguous()
        r = resid(levels, x)
        mg = dict(MG5, nu=nu)
        n0, l0 = v3.v_cycle3d.launches, lib.deff_launch_count()
        z = v3.v_cycle3d(levels, r, **mg)
        torch.cuda.synchronize()
        check(v3.v_cycle3d.launches == n0 + 1, "K6 whole launches")
        shapes = [tuple(c.diag.shape[-3:]) for c in levels]
        per_cycle = lib.deff_launch_count() - l0
        want = v3.cycle3_launches(shapes, r.element_size())
        check(per_cycle == want, f"K6 whole {shape} {dtype}: {per_cycle} "
              f"launches a cycle, the resident rule gives {want}")
        zp = v3.v_cycle3d_reference(levels, r, **mg)
        err = float((z - zp).abs().max())
        check(bool(torch.equal(z, zp)), f"K6 whole {shape} {dtype}: max abs "
              f"err {err}, not bit-identical")
        k6w_err = max(k6w_err, err)
        lines.append(f"B=2 x {shape} {str(dtype)[-7:]} nu={nu}, "
                     f"{len(levels)} levels, resident from level "
                     f"{v3.cycle3_resident_from(shapes, r.element_size())}, "
                     f"{per_cycle} launches: max abs err {err:.3e} (max|z| "
                     f"{float(zp.abs().max()):.3e})")
        del d, c, levels, x, r, z, zp
    phase(18, t0, "K6 whole cycle vs plain: " + "; ".join(lines))

    # -- 19: K6's banded cycle against its plain version
    t0 = time.perf_counter()
    fluid5 = c5_fluid((C5_SIZE,) * 3, C5_SEED)
    k6b_err, lines = 0.0, []
    cases = ((fluid5[None], torch.float32, 2),
             (fluid5[None], torch.float64, 3),
             (np.stack([c5_fluid((100, 64, 90), 43 + i) for i in range(2)]),
              torch.float32, 2),
             (c5_fluid((48, 48, 48), 45)[None], torch.float64, 3))
    for fluid, dtype, nu in cases:
        d, c, _, x0 = c5_problem(fluid, dev, dtype)
        levels, x, _ = tiled3d_setup(d, c, x0)
        r = resid(levels, x)
        mg = dict(MG5, nu=nu)
        shapes = [tuple(c.diag.shape[-3:]) for c in levels]
        item = r.element_size()
        tail = v3.cycle3_launches(shapes[1:], item)
        n6, n6w = v3.v_cycle3d_tiled.launches, v3.v_cycle3d.launches
        l0 = lib.deff_launch_count()
        z = v3.v_cycle3d_tiled(levels, r, **mg)
        torch.cuda.synchronize()
        per_cycle = lib.deff_launch_count() - l0
        check(v3.v_cycle3d_tiled.launches == n6 + 1
              and v3.v_cycle3d.launches == n6w + 1, "K6 banded launches")
        check(per_cycle == 2 + tail, f"K6 banded {tuple(fluid.shape)}: "
              f"{per_cycle} launches a cycle, T1, T2 and the rule's {tail}")
        zp = v3.v_cycle3d_tiled_reference(levels, r, **mg)
        err = float((z - zp).abs().max())
        check(bool(torch.equal(z, zp)), f"K6 banded {tuple(fluid.shape)}: "
              f"max abs err {err}, not bit-identical")
        k6b_err = max(k6b_err, err)
        # the whole cycle as the main path calls it: on levels[1:]
        r1 = torch.randn((fluid.shape[0],) + shapes[1], dtype=dtype,
                         device=dev)
        l0 = lib.deff_launch_count()
        z1 = v3.v_cycle3d(levels[1:], r1, **mg)
        torch.cuda.synchronize()
        per_tail = lib.deff_launch_count() - l0
        check(per_tail == tail, f"K6 whole on levels[1:] of "
              f"{tuple(fluid.shape)}: {per_tail} launches, the rule's {tail}")
        zp1 = v3.v_cycle3d_reference(levels[1:], r1, **mg)
        err1 = float((z1 - zp1).abs().max())
        check(bool(torch.equal(z1, zp1)), f"K6 whole on levels[1:] of "
              f"{tuple(fluid.shape)} {dtype}: max abs err {err1}, not "
              "bit-identical")
        k6w_err = max(k6w_err, err1)
        lines.append(f"B={fluid.shape[0]} x {tuple(fluid.shape[1:])} "
                     f"{str(dtype)[-7:]} nu={nu} padded to "
                     f"{tuple(r.shape[1:])}, {len(levels)} levels: max abs "
                     f"err {err:.3e}, {per_cycle} launches; the whole cycle "
                     f"on levels[1:] (resident from its level "
                     f"{v3.cycle3_resident_from(shapes[1:], item)}): max abs "
                     f"err {err1:.3e}, {per_tail} launches")
        del d, c, levels, x, r, z, zp, r1, z1, zp1
    phase(19, t0, "K6 banded cycle vs plain: " + "; ".join(lines))

    # -- 20: K7 against its plain version, B=4 x 256^3, k=5
    t0 = time.perf_counter()
    fluid4 = np.stack([fluid5] + [c5_fluid((C5_SIZE,) * 3, C5_SEED + i)
                                  for i in (1, 2, 3)])
    d4, c4, _, x04 = c5_problem(fluid4, dev)
    levels4, x4, mf4 = tiled3d_setup(d4, c4, x04)
    r4 = resid(levels4, x4)
    p4 = v3.v_cycle3d_tiled(levels4, r4, **MG5)
    rz = batch_sum(r4 * p4)
    sr0 = batch_sum(r4.abs())
    active = torch.ones(4, device=dev)
    active[1] = 0.0                              # frozen
    stop = torch.zeros(4, device=dev)
    stop[2] = 10.0 * sr0[2]                      # exits at iteration 0
    hi = torch.full((4,), float("inf"), device=dev)
    rz[3] *= 1e3                                 # overshoots ...
    hi[3] = 2.0 * sr0[3]                         # ... and trips its hi
    state = (x4, r4, p4, rz, active, stop, hi)
    k7_err, lines = 0.0, []
    for mode, extra in (("stored", {}), ("matrix-free", mf4)):
        got = cg_steps3d(levels4, *(t.clone() for t in state), 5, **MG5,
                         **extra)
        ref = cg_steps3d_reference(levels4, *(t.clone() for t in state), 5,
                                   **MG5, **extra)
        torch.cuda.synchronize()
        kd = got[4].tolist()
        check(kd == ref[4].tolist(), f"K7 {mode} k_done {kd} != plain "
              f"{ref[4].tolist()}")
        check(kd[:3] == [5, 0, 0] and kd[3] >= 1, f"K7 {mode} k_done {kd}")
        err_m = 0.0
        for nm, g, e in zip("xrp", got[:3], ref[:3]):
            for b in range(4):
                err = float((g[b] - e[b]).abs().max())
                scale = float(e[b].abs().max())
                check(err <= 1e-4 * scale,
                      f"K7 {mode} {nm}[{b}] err {err} > 1e-4*{scale}")
                err_m = max(err_m, err)
        rz_err = float(((got[3] - ref[3]).abs() / ref[3].abs()).max())
        check(rz_err <= 1e-3, f"K7 {mode} rz rel err {rz_err}")
        # float32 products summed in double and rounded once: bit for bit
        bit = all(bool(torch.equal(g, e)) for g, e in zip(got[:4], ref[:4]))
        check(bit, f"K7 {mode}: x/r/p/rz not bit-equal to the plain "
              f"version (max abs err {err_m})")
        for g, e in zip(got[:4], ref[:4]):
            check(bool(torch.equal(g[1], e[1])), f"K7 {mode} frozen volume")
        k7_err = max(k7_err, err_m)
        lines.append(f"{mode}: k_done {kd}, max abs err x/r/p {err_m:.3e}, "
                     f"rz max rel err {rz_err:.3e}, bit-equal {bit}")
        del got, ref
    phase(20, t0, "K7 vs plain, B=4 x 256^3 fp32, k=5: " + "; ".join(lines))
    del state, levels4, x4, mf4, r4, p4
    torch.cuda.empty_cache()

    # the float64 instantiation at nu = 3 (the deepest chain a pass runs) on
    # config 5's volume, B=1: float64 products summed in another order than
    # the plain version's, so within 1e-9 of max|.|
    t0 = time.perf_counter()
    d64, c64, _, x064 = c5_problem(fluid5[None], dev, torch.float64)
    lv64, x64, mf64 = tiled3d_setup(d64, c64, x064)
    r64 = resid(lv64, x64)
    mg3 = dict(MG5, nu=3)
    p64 = v3.v_cycle3d_tiled(lv64, r64, **mg3)
    one = torch.ones(1, dtype=torch.float64, device=dev)
    state = (x64, r64, p64, batch_sum(r64 * p64), one, 0 * one,
             one * float("inf"))
    lines = []
    for mode, extra in (("stored", {}), ("matrix-free", mf64)):
        got = cg_steps3d(lv64, *(t.clone() for t in state), 5, **mg3,
                         **extra)
        ref = cg_steps3d_reference(lv64, *(t.clone() for t in state), 5,
                                   **mg3, **extra)
        torch.cuda.synchronize()
        kd = got[4].tolist()
        check(kd == ref[4].tolist() == [5], f"K7 fp64 {mode} k_done {kd}")
        err_m = 0.0
        for nm, g, e in zip("xrp", got[:3], ref[:3]):
            err = float((g - e).abs().max())
            check(err <= 1e-9 * float(e.abs().max()),
                  f"K7 fp64 {mode} {nm} err {err}")
            err_m = max(err_m, err)
        rz_err = float(((got[3] - ref[3]).abs() / ref[3].abs()).max())
        check(rz_err <= 1e-9, f"K7 fp64 {mode} rz rel err {rz_err}")
        bit = all(bool(torch.equal(g, e)) for g, e in zip(got[:4], ref[:4]))
        lines.append(f"{mode}: k_done {kd}, max abs err x/r/p {err_m:.3e}, "
                     f"rz rel err {rz_err:.3e}, bit-equal {bit}")
        del got, ref
    phase(20, t0, "K7 vs plain, B=1 x 256^3 fp64 nu=3, k=5: "
          + "; ".join(lines))
    del d64, c64, x064, lv64, x64, mf64, r64, p64, state
    torch.cuda.empty_cache()

    # -- 21: BASELINE config 5 through solve_mgcg_3d, engine by the auto rule
    t0 = time.perf_counter()
    d1, c1, s1, x01 = c5_problem(fluid5, dev)
    legs, main_launches = {}, None
    for name, extra in (("matrix-free", dict(d_field=d1)), ("stored", {})):
        torch.cuda.synchronize()
        cyc0 = zero_counts()
        t1 = time.perf_counter()
        res = solvers3d.solve_mgcg_3d(c1, s1, x01, **C5_KW, **extra)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t1
        launched = counts(cyc0)
        if main_launches is None:
            main_launches = launched
        check(launched["K6 banded"] > 0 and launched["K6 whole"] > 0
              and launched["K7"] > 0, f"config 5 {name} launches {launched}")
        conv, deff, iters = float(res.conv), float(res.deff), int(res.iters)
        check(np.isfinite(deff) and conv <= C5_KW["tol"],
              f"config 5 {name}: relres {conv}, Deff {deff}")
        # each K7 window stops at most WINDOW_LAG iterations after its last
        # live one
        check(launched["K7 iterations launched"]
              <= iters + WINDOW_LAG * launched["K7"],
              f"config 5 {name}: {launched['K7 iterations launched']} K7 "
              f"iterations launched for {iters} live in {launched['K7']} "
              "windows")
        plain = solvers3d._mgcg3_core(c1, s1, x01, batched=False, plain=True,
                                      **C5_KW, **extra)
        p_deff, p_iters = float(plain.deff), int(plain.iters)
        rel = abs(deff - p_deff) / abs(p_deff)
        check(rel <= 1e-4 and abs(iters - p_iters) <= 2,
              f"config 5 {name} vs plain: Deff {deff} / {p_deff}, "
              f"iterations {iters} / {p_iters}")
        solvers3d.solve_mgcg_3d(c1, s1, x01, **C5_KW, **extra)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            res = solvers3d.solve_mgcg_3d(c1, s1, x01, **C5_KW, **extra)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        legs[name] = deff
        phase(21, t0, f"BASELINE config 5 {name} {card}: 256^3 fp32, "
              f"{iters} iterations (plain {p_iters}; the JAX package's "
              f"record {C5_JAX_ITERS}), relres {conv:.3e}, Deff {deff:.6f} "
              f"(plain {p_deff:.6f}, rel err {rel:.3e}), first run "
              f"{t_first:.4f} s, timed "
              f"{', '.join(f'{t:.4f}' for t in times)} s, "
              f"{min(times) / iters * 1e3:.4f} ms/iteration, peak memory "
              f"{peak / 2**30:.3f} GiB, launches {launched} (K7 "
              f"iterations launched {launched['K7 iterations launched']} "
              f"for {iters} live, 3D cycles "
              f"{launched['3D cycles in the library']})")
        t0 = time.perf_counter()
        del res, plain
    rel_sm = abs(legs["stored"] - legs["matrix-free"]) / abs(legs["stored"])
    check(rel_sm <= 1e-3, f"stored vs matrix-free Deff rel err {rel_sm}")
    phase(21, t0, f"stored vs matrix-free Deff rel err {rel_sm:.3e}")

    # -- 22: the CLI route
    t0 = time.perf_counter()
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    results = []
    vol5 = np.where(fluid5, 0, 255).astype(np.uint8)
    np.save(WORK_DIR / "vol.npy", vol5)
    # mean|r| <= 2e-4 mean|b| (off the fp32 floor), at most 400 iterations
    tol5 = float(f"{2e-4 * float(fvm3d.residual_3d(c1, 0 * x01)):.3e}")
    csv = WORK_DIR / "volume.csv"
    csv.unlink(missing_ok=True)
    inp = WORK_DIR / "input_volume.txt"
    inp.write_text(f"Phases: 2\nInputName: {WORK_DIR / 'vol.npy'}\n"
                   f"Ds: {CONTRAST}\nDf: 1\nSolver: mgcg\n"
                   f"Criterion: residual\nConvergence: {tol5}\n"
                   f"MaxIter: 400\nOutputName: {csv}\n")
    seen = []
    volume_sim = pvol.volume_sim

    def observed(*a, **kw):
        out = volume_sim(*a, **kw)
        seen.append(out)
        return out

    pvol.volume_sim = observed               # to read the pipeline's result
    try:
        cyc0 = zero_counts()
        rc = cli.main([str(inp)])
        torch.cuda.synchronize()
    finally:
        pvol.volume_sim = volume_sim
    l_cli = counts(cyc0)
    check(rc == 0 and len(seen) == 1, f"cli.main returned {rc}")
    check(l_cli["K7"] > 0 and l_cli["K6 banded"] > 0,
          f"CLI volume launches {l_cli}")
    v_res = seen[0]
    cfg = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=CONTRAST,
                           solver="mgcg", criterion="residual",
                           convergence=tol5, max_iter=400)
    direct = solvers3d.solve_mgcg_3d(
        c1, s1, x01, tol=cfg.convergence, max_iter=cfg.max_iter,
        check_every=cfg.check_every, criterion=cfg.criterion,
        first_window=cfg.first_window, d_field=d1)
    rel_cli = abs(v_res.deff - float(direct.deff)) / abs(float(direct.deff))
    check(rel_cli <= 1e-6 and v_res.iters == int(direct.iters),
          f"CLI volume Deff {v_res.deff} vs direct {float(direct.deff)}")
    rows = csv.read_text().splitlines()
    check(len(rows) == 2 and abs(float(rows[1].split(",")[3]) - v_res.deff)
          <= 1e-6, f"CLI CSV {rows}")
    results.append(f"vol.npy (256^3, V(1,1) defaults, mean|r| <= {tol5:.3e})"
                   f": Deff {v_res.deff:.6f}, {v_res.iters} iterations, "
                   f"solve {v_res.time_s:.3f} s, vs the direct solve rel err "
                   f"{rel_cli:.3e}, launches {l_cli}")
    del direct, seen

    slabs = []
    for n_phase, want in ((2, 0.5 + 0.5 * CONTRAST), (3, 0.5 + 0.25 * 200.0)):
        vol = np.full((32, 32, 48), 255, np.uint8)
        vol[:, :16, :] = 0 if n_phase == 2 else 100
        if n_phase == 3:
            vol[:, 16:24, :] = 0
        cfg_s = SimulationConfig(n_phase=n_phase, d_fluid=1.0,
                                 d_solid=CONTRAST if n_phase == 2 else 0.0,
                                 d_gas=200.0, dtype="float64", solver="mgcg",
                                 criterion="relresidual", convergence=1e-10,
                                 max_iter=400)
        run = pvol.volume_sim if n_phase == 2 else pvol.volume_sim_3phase
        got_s = run(cfg_s, vol, device="cuda").deff
        check(abs(got_s - want) <= 1e-5 * abs(want),
              f"{n_phase}-phase slab Deff {got_s} vs {want}")
        slabs.append(abs(got_s - want) / abs(want))
    results.append(f"32x32x48 fp64 slabs vs analytic Deff: rel err 2-phase "
                   f"{slabs[0]:.3e}, 3-phase {slabs[1]:.3e}")

    vdir = WORK_DIR / "volumes"
    vdir.mkdir(parents=True, exist_ok=True)
    vols = [np.where(c5_fluid((64, 64, 64), 51 + i), 0, 255).astype(np.uint8)
            for i in range(4)]
    for i, v in enumerate(vols):
        np.save(vdir / f"{i:05d}.npy", v)
    _, cb, _, xb = c5_problem(vols[0] < 150, dev)
    tol64 = float(f"{2e-4 * float(fvm3d.residual_3d(cb, 0 * xb)):.3e}")
    csvb = WORK_DIR / "volume_batch.csv"
    csvb.unlink(missing_ok=True)             # a stale file would be resumed
    inpb = WORK_DIR / "input_volume_batch.txt"
    inpb.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: 4\n"
                    f"ImageDir: {vdir}\nDs: {CONTRAST}\nDf: 1\n"
                    f"Solver: mgcg\nCriterion: residual\n"
                    f"Convergence: {tol64}\nMaxIter: 400\n"
                    f"OutputName: {csvb}\n")
    cyc0 = zero_counts()
    check(cli.main([str(inpb)]) == 0, "cli.main on the volume batch")
    torch.cuda.synchronize()
    l_batch = counts(cyc0)
    check(l_batch["K7"] > 0, f"CLI volume batch launches {l_batch}")
    brows = [ln.split(",") for ln in csvb.read_text().splitlines()
             if ln.split(",")[0].isdigit()]
    check([int(r[0]) for r in brows] == [0, 1, 2, 3], f"batch rows {brows}")
    cfg_b = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=CONTRAST,
                             solver="mgcg", criterion="residual",
                             convergence=tol64, max_iter=400)
    diffs = []
    for r_b, v in zip(brows, vols):
        single = pvol.volume_sim(cfg_b, v, device="cuda")
        diffs.append(abs(float(r_b[3]) - single.deff))
        check(diffs[-1] <= 2e-6 and int(r_b[5]) == v.size,
              f"batch row {r_b} vs single Deff {single.deff}")
    results.append(f"RunBatch 4 x 64^3 (mean|r| <= {tol64:.3e}): Deff "
                   f"{', '.join(r_b[3] for r_b in brows)}, max |batch - "
                   f"single| {max(diffs):.1e} (CSV %f), launches {l_batch}")
    phase(22, t0, "CLI route: " + "; ".join(results))

    # -- 23: K6/K7 times (CUDA events)
    t0 = time.perf_counter()
    times, lines = {}, []
    for bsz in (1, 4):
        sub = slice(0, bsz)
        levels, x, mf = tiled3d_setup(d4[sub],
                                      type(c4)(*(a[sub] for a in c4)),
                                      x04[sub])
        r = resid(levels, x)
        item = x.element_size()
        ms = cuda_ms(lambda: v3.v_cycle3d_tiled(levels, r, **MG5), 5, warm=1)
        ms_p = cuda_ms(lambda: v3.v_cycle3d_tiled_reference(levels, r,
                                                            **MG5), 1)
        n0 = lib.deff_launch_count()
        v3.v_cycle3d_tiled(levels, r, **MG5)
        per_cycle = lib.deff_launch_count() - n0
        shapes = [tuple(c.diag.shape[-3:]) for c in levels]
        tail = v3.cycle3_launches(shapes[1:], item)
        check(per_cycle == 2 + tail, f"K6 banded {per_cycle} launches a "
              f"cycle: T1, T2 and {tail} for the whole cycle on levels[1:]")
        work = banded3_work(levels, bsz, item, MG5["nu"])
        bd = bound(*work[:2], item)
        times[("K6 banded", bsz)] = (ms, ms_p, bd)
        dms = device_ms(lambda: v3.v_cycle3d_tiled(levels, r, **MG5), 5)
        lines.append(f"B={bsz} K6 banded cycle {ms:.4f} ms (device "
                     f"{'not measured' if dms is None else f'{dms:.4f} ms'}"
                     f"; plain {ms_p:.4f} ms, bound {bd[0]:.4f} ms by "
                     f"{bd[1]}, level 0 read once "
                     f"{bound(work[2], work[1], item)[0]:.4f} ms; "
                     f"{per_cycle} launches)")
        # the whole cycle as the main path calls it: the tail on levels[1:]
        r1 = torch.randn(levels[1].diag.shape, dtype=r.dtype, device=dev)
        ms = cuda_ms(lambda: v3.v_cycle3d(levels[1:], r1, **MG5), 5, warm=1)
        ms_p = cuda_ms(lambda: v3.v_cycle3d_reference(levels[1:], r1,
                                                      **MG5), 1)
        bd = bound(*cycle3_work(levels[1:], bsz, item, MG5["nu"])[:2], item)
        times[("K6 whole", bsz)] = (ms, ms_p, bd)
        dms = device_ms(lambda: v3.v_cycle3d(levels[1:], r1, **MG5), 5)
        lines.append(f"B={bsz} K6 whole cycle on levels[1:] {ms:.4f} ms "
                     f"a wrapper call (device "
                     f"{'not measured' if dms is None else f'{dms:.4f} ms'}"
                     f"; plain {ms_p:.4f} ms, bound {bd[0]:.4f} ms by "
                     f"{bd[1]}; {tail} launches, resident from its level "
                     f"{v3.cycle3_resident_from(shapes[1:], item)}, reckoned "
                     f"{item * k6_tail_cells(shapes[1:], item) / 2**20:.2f} "
                     f"MiB a volume)")
        p = v3.v_cycle3d_tiled(levels, r, **MG5)
        rz = batch_sum(r * p)
        ones = torch.ones(bsz, device=dev)
        zero = torch.zeros(bsz, device=dev)
        inf = torch.full((bsz,), float("inf"), device=dev)
        for mode, extra in (("stored", {}), ("matrix-free", mf)):
            def k7(fn, k=K7_TIME_K, reps=3):
                states = [(x.clone(), r.clone(), p.clone())
                          for _ in range(reps)]
                return lambda: fn(levels, *states.pop(), rz, ones, zero, inf,
                                  k, **MG5, **extra)

            n0 = lib.deff_launch_count()
            k7(cg_steps3d, 0, 1)()
            n1 = lib.deff_launch_count()
            k7(cg_steps3d, K7_TIME_K, 1)()
            per_iter = (lib.deff_launch_count() - n1 - (n1 - n0)) / K7_TIME_K
            check(per_iter == 5 + tail, f"K7 {per_iter} launches an "
                  f"iteration: three passes, two finalizes and {tail} for "
                  "K6's tail")
            ms = cuda_ms(k7(cg_steps3d), 2)
            ms_p = cuda_ms(k7(cg_steps3d_reference, reps=2), 1)
            work = cg3_work(levels, bsz, item, MG5["nu"], K7_TIME_K,
                            mf=bool(extra))
            bd = bound(*work[:2], item)
            times[(mode, bsz)] = (ms, ms_p, bd)
            lines.append(f"B={bsz} K7 {mode} k={K7_TIME_K} {ms:.4f} ms "
                         f"({ms / K7_TIME_K:.4f} ms/iteration; plain "
                         f"{ms_p:.4f} ms, bound {bd[0]:.4f} ms by {bd[1]} "
                         f"(level 0 read once a call: "
                         f"{bound(work[2], work[1], item)[0]:.4f} ms), "
                         f"{per_iter:g} launches/iteration (three passes, "
                         f"two finalizes, {tail} for K6's tail), reckoned "
                         f"{k7_bytes_per_cell(levels, item, bool(extra)):.1f}"
                         f" B/cell an iteration)")
        del levels, x, mf, r, r1, p
        torch.cuda.empty_cache()
    phase(23, t0, f"K6/K7 times {card}, 256^3 fp32: " + "; ".join(lines))
    del d4, c4, x04

    # -- 24: one config-5 solve per leg under the profiler
    t0 = time.perf_counter()
    lines = []
    for name, extra in (("matrix-free", dict(d_field=d1)), ("stored", {})):
        prof = profile_solve(
            lambda: solvers3d.solve_mgcg_3d(c1, s1, x01, **C5_KW, **extra),
            PROFILE_GROUPS_3D)
        if prof is None:
            lines.append(f"{name}: the profiler saw no device time")
            continue
        busy, span, wall, groups = prof
        lines.append(
            f"{name}: device busy {busy:.3f} ms of a {span:.3f} ms kernel "
            f"span (idle share {1 - busy / span:.1%}; wall {wall:.3f} ms "
            "under the profiler), by group " + ", ".join(
                f"{g} {ms:.3f} ms ({ms / busy:.0%})" for g, ms in
                sorted(groups.items(), key=lambda kv: -kv[1])))
    phase(24, t0, f"config 5 profile {card}: " + "; ".join(lines))

    rows = []
    for name, key, src, rep, err in (
            ("v_cycle3d", "K6 whole", "vcycle3d.cu", "vcycle3d.py:202",
             k6w_err),
            ("v_cycle3d_tiled", "K6 banded", "levelpass3d.cuh",
             "vcycle3d.py:567", k6b_err),
            ("cg_steps3d", "matrix-free", "cgstep3d.cu", "cgstep3d.py:199",
             k7_err)):
        ms, ms_p, bd = times[(key, 1)]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"effectivediffusivityfvm_tpu_torch/csrc/{src}",
            "replaces": f"effectivediffusivityfvm_tpu/ops/kernels/{rep}",
            "launches": main_launches["K7" if key == "matrix-free" else key],
            "max_abs_err": err, "ms": ms, "plain_ms": ms_p,
            "bound_ms": bd[0], "bound_by": bd[1], "library_ms": None})
    return rows


# kernel-name fragments -> the group a sharded profile reports them under
PROFILE_GROUPS_SHARDED = (
    ("K9 passes", ("shard_p_kernel", "shard_x_kernel", "shard_z_kernel")),
    ("K8 T1/T2", ("row_t1", "row_t2")),
    ("K9 finalize", ("fin_init", "fin_alpha", "fin_live", "shard_abs_parts",
                     "select_kernel")),
    ("K2 tail", K2_KERNELS),
    ("strip and gather copies", ("Memcpy", "copy_kernel", "CatArray")),
)
K8_KERNELS = ("row_t1", "row_t2")     # K8's kernels (csrc/vcycle_sharded.cu)
K9_PASSES = ("shard_p_kernel", "shard_x_kernel",   # K9's passes
             "shard_z_kernel")                     # (csrc/cgstep_sharded.cu)
C4K_SIZE = 4096                       # phase 25/27: a sharded level 1 too
K9_TIME_K = 10                        # iterations per timed K9 call


def k8_own_text(own):
    """K8's own device time (its kernels) beside the application's."""
    if own is None:
        return "not measured"
    return (f"K8's kernels {own[0] / 1e3:.4f} ms of {own[1] / 1e3:.4f} ms "
            "(all kernels and copies)")


def sharded_setup(c, sp, dev, min_size):
    """One mesh row of ``sp`` shards of ``dev`` over the system ``c``: the
    mesh, the sharded hierarchy, its coefficient strips and its tail."""
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, halo, mesh

    m = mesh.make_mesh(sp, devices=[dev] * sp)
    sh = [mesh.shard_rows(m, a)[0] for a in c]
    row = [fvm.StencilCoeffs(*(f[s] for f in sh)) for s in range(sp)]
    hier = halo._build_sharded_hierarchy_2d(row, c.diag.shape[-2] // sp,
                                            min_size=min_size)
    return (m, hier, fused2d._coef_windows(hier.sharded),
            fused2d.build_fused_tail(hier.sharded, min_size))


def sharded_work(hier, tail, sp, bsz, itemsize, nu, k=None):
    """Bytes and operations of one sharded cycle (``k=None``: a K8
    application) or of a K9 call of ``k`` iterations with every image live,
    by tiled_work's rule, over the levels the cycle visits: a sharded
    level's working set is larger than L2 at the main path's sizes, so it
    counts as a whole grid in every pass that must read it -- K8's T1 and
    T2 each read r and the three coefficient planes, and z is written (9
    planes a level above the tail); K9 each iteration reads x, r, p, z and
    level 0's three coefficient planes once and writes x, r, p, z once (11
    planes), plus the cycle from level 1 -- and the tail's hierarchy as
    cycle_work counts it, once a cycle.  Operations: cycle_work's over
    every level, and for K9 22 a level-0 cell an iteration for the CG
    updates, products and sums.  The earlier reckoning counted level 0
    once a call."""
    stop = tail[0] if tail[0] is not None else len(hier.sharded)
    rest = tail[1][0] if tail[0] is not None else hier.replicated[0]
    fused = [bsz * c[0].diag.shape[-2] * sp * c[0].diag.shape[-1]
             for c in hier.sharded[:stop]]
    tail_bytes, tail_ops, _ = cycle_work(rest, bsz, itemsize, nu)
    ops = (5 + 24 * nu) * sum(fused) + tail_ops
    from1 = itemsize * 9 * sum(fused[1:]) + tail_bytes
    if k is None:
        return itemsize * 9 * fused[0] + from1, ops
    n0 = fused[0]
    return k * (itemsize * 11 * n0 + from1), k * (ops + 22 * n0)


class K9Watch:
    """Inside K9's windows only, counts the strip exchanges (``halo_strips``
    wherever it is called, and K9's own cross-device exchanges) and the
    coarse planes gathered or split (``gathered_cycle``, ``all_gather``).
    ``watch.wrap(fn)`` marks a K9 call; within ``with watch:`` the solver's
    K9 (``fused2d_cg.cg_steps_sharded``) is marked too."""

    def __init__(self):
        from effectivediffusivityfvm_tpu_torch.ops.kernels import (
            cgstep_sharded, vcycle_sharded)
        from effectivediffusivityfvm_tpu_torch.parallel import (
            fused2d, fused2d_cg, halo, mesh)

        self.k9 = cgstep_sharded.cg_steps_sharded
        self.inside = False
        self.strips = self.gathers = 0
        self.targets = [(m, "halo_strips", "strips") for m in (
            mesh, vcycle_sharded, cgstep_sharded, fused2d, halo)]
        self.targets += [(fused2d, "gathered_cycle", "gathers"),
                         (halo, "all_gather", "gathers"),
                         (mesh, "all_gather", "gathers")]
        self.solver = fused2d_cg
        self.saved = []

    def wrap(self, fn):
        def call(*a, **k):
            ex = self.k9.exchanges
            self.inside = True
            try:
                return fn(*a, **k)
            finally:
                self.inside = False
                self.strips += self.k9.exchanges - ex
        return call

    def _counted(self, fn, what):
        def call(*a, **k):
            if self.inside:
                setattr(self, what, getattr(self, what) + 1)
            return fn(*a, **k)
        return call

    def __enter__(self):
        for mod, name, what in self.targets:
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, self._counted(getattr(mod, name), what))
        self.saved.append((self.solver, "cg_steps_sharded",
                           self.solver.cg_steps_sharded))
        self.solver.cg_steps_sharded = self.wrap(
            self.solver.cg_steps_sharded)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved = []


def sharded_phases(dev, card, lib, c3_stored, imgs64, inp10_text, table10):
    """Phases 25-29 (the row-sharded engine on shards of one card); returns
    the rows of the kernels' JSON line for K8 and K9."""
    import torch

    from effectivediffusivityfvm_tpu_torch.config import parse_input_file
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
        batch_sum, cg_steps)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_sharded import (
        WINDOW_LAG, ShardWorkspace, cg_steps_sharded,
        cg_steps_sharded_reference)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import \
        cg_steps_tiled
    from effectivediffusivityfvm_tpu_torch.ops.kernels import vcycle_sharded
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import (
        cycle_launches, v_cycle)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_sharded import (
        shard_row_t1, shard_row_t2)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_tiled import \
        v_cycle_tiled
    from effectivediffusivityfvm_tpu_torch.parallel import fused2d, halo, mesh
    from effectivediffusivityfvm_tpu_torch.parallel.dryrun import \
        dryrun_multichip
    from effectivediffusivityfvm_tpu_torch.pipeline import batch
    from effectivediffusivityfvm_tpu_torch.solvers import multigrid

    wrappers = (shard_row_t1, shard_row_t2, cg_steps_sharded, v_cycle,
                cg_steps,
                v_cycle_tiled, cg_steps_tiled)

    def zero_counts():
        for w in wrappers:
            w.launches = 0

    def counts():
        return {"K8 T1": shard_row_t1.launches,
                "K8 T2": shard_row_t2.launches,
                "K9": cg_steps_sharded.launches, "K2": v_cycle.launches,
                "K1": cg_steps.launches, "K4": v_cycle_tiled.launches,
                "K5": cg_steps_tiled.launches}

    def joined(shards):
        return torch.cat(list(shards), dim=-2)

    def host_loop(fn):
        """Run fn with K9 on its host loop (every workspace made meanwhile
        takes graph=False), to compare the two routes."""
        init = ShardWorkspace.__init__
        init.__defaults__ = (False, None)
        try:
            return fn()
        finally:
            init.__defaults__ = (True, None)

    # -- 25: K8 against its plain version, one application of the cycle
    t0 = time.perf_counter()
    rng = np.random.default_rng(C3_SEED)
    imgs2 = np.stack([correlated_binary(rng, C3_SIZE, C3_SIZE)
                      for _ in range(2)])
    rng = np.random.default_rng(C3_SEED)
    img4k = correlated_binary(rng, C4K_SIZE, C4K_SIZE)
    rng = np.random.default_rng(5)
    imgs64f = np.stack([correlated_binary(rng, 256, 320) for _ in range(2)])
    k8_err, lines = 0.0, []
    for imgs_, sp, dtype in ((imgs2, 4, torch.float32),
                             (imgs2, 1, torch.float32),
                             (img4k[None], 4, torch.float32),
                             (imgs64f, 4, torch.float64)):
        d, c, _, x0 = c3_problem(imgs_, dev, dtype)
        r = c.b - fvm.apply_operator(c, x0)
        m, hier, cw, tail = sharded_setup(c, sp, dev, C3_KW["min_size"])
        rs = mesh.shard_rows(m, r)[0]
        rows = {}
        zero_counts()
        n0 = lib.deff_launch_count()
        strips = vcycle_sharded.halo_strips
        n_strips = []

        def counted(*a, **k):
            n_strips.append(1)
            return strips(*a, **k)

        vcycle_sharded.halo_strips = counted
        try:
            z = joined(fused2d.v_cycle_sharded_fused(hier, cw, rs, tail=tail,
                                                     rows=rows, **MG3))
        finally:
            vcycle_sharded.halo_strips = strips
        torch.cuda.synchronize()
        n, n_lib = counts(), lib.deff_launch_count() - n0
        n_fused = sum(cw_l is not None for cw_l in cw[:tail[0]])
        tail_shapes = [tuple(cl.diag.shape[-2:]) for cl in tail[1][0]]
        want = 2 * n_fused + cycle_launches(tail_shapes, r.element_size())
        check(n["K8 T1"] == n["K8 T2"] == n_fused and n["K2"] == 1
              and n_lib == want and not n_strips
              and rows[tail[0] - 1].gathered is not None,
              f"K8 launches {n}, library launches {n_lib} (want {want}), "
              f"strip exchanges {len(n_strips)}, levels {sorted(rows)}")
        zp = joined(fused2d.v_cycle_sharded_fused(hier, cw, rs, tail=tail,
                                                  plain=True, **MG3))
        err = float((z - zp).abs().max())
        scale = float(zp.abs().max())
        check(torch.equal(z, zp), f"K8 {tuple(r.shape)} SP={sp}: "
              f"max|z - z_plain| {err} (bit-equal expected)")
        k8_err = max(k8_err, err)

        def app():
            return fused2d.v_cycle_sharded_fused(hier, cw, rs, tail=tail,
                                                 rows=rows, **MG3)

        ms = cuda_ms(app, 5, warm=1)
        own = kernel_device_us(app, 5, K8_KERNELS)
        lines.append(f"B={r.shape[0]} x {r.shape[1]}x{r.shape[2]} "
                     f"{str(dtype)[-7:]} SP={sp}: {len(hier.sharded)} "
                     f"sharded levels, tail at level {tail[0]}: max abs err "
                     f"{err:.3e} (max|z| {scale:.3e}), bit-equal True; T1 "
                     f"{n['K8 T1']}, T2 {n['K8 T2']} launches, K2 "
                     f"{n['K2']} call, {n_lib} library launches, "
                     f"{len(n_strips)} strip exchanges; an application "
                     f"{ms:.4f} ms, device {k8_own_text(own)}")
        del d, c, x0, r, rs, hier, cw, tail, z, zp, rows
    phase(25, t0, "K8 vs plain: " + "; ".join(lines))

    # -- 26: K9 against its plain version, B=4 x 2048^2, SP=4, k=5
    t0 = time.perf_counter()
    rng = np.random.default_rng(C3_SEED)
    imgs4 = np.stack([correlated_binary(rng, C3_SIZE, C3_SIZE)
                      for _ in range(4)])
    d4, c4, _, x04 = c3_problem(imgs4, dev)
    x4 = x04.contiguous()
    m4, hier4, cw4, tail4 = sharded_setup(c4, 4, dev, C3_KW["min_size"])
    r4 = c4.b - fvm.apply_operator(c4, x4)
    p4 = joined(fused2d.v_cycle_sharded_fused(
        hier4, cw4, mesh.shard_rows(m4, r4)[0], tail=tail4, **MG3))
    rz = batch_sum(r4 * p4)
    sr0 = batch_sum(r4.abs())
    active = torch.ones(4, device=dev)
    active[1] = 0.0                              # frozen
    stop = torch.zeros(4, device=dev)
    stop[2] = 10.0 * sr0[2]                      # exits at iteration 0
    hi = torch.full((4,), float("inf"), device=dev)
    rz[3] *= 1e3                                 # overshoots ...
    hi[3] = 2.0 * sr0[3]                         # ... and trips its hi

    def k9_run(fn, plain, k=5):
        xs, rs, ps = (mesh.shard_rows(m4, t)[0] for t in (x4, r4, p4))
        kw9 = fused2d.k9_coarse(hier4, cw4, xs, tail=tail4, plain=plain,
                                **MG3)
        out = fn(cw4[0], xs, rs, ps, rz.clone(), active, stop, hi, k,
                 omega=MG3["omega"], nu=MG3["nu"], over=MG3["over"], **kw9)
        return [joined(out[i]) for i in range(3)] + list(out[3:])

    r0 = cg_steps_sharded.replays
    with K9Watch() as watch:
        got = k9_run(watch.wrap(cg_steps_sharded), False)
        torch.cuda.synchronize()
    replays = cg_steps_sharded.replays - r0
    loop = host_loop(lambda: k9_run(cg_steps_sharded, False))
    ref = k9_run(cg_steps_sharded_reference, True)
    torch.cuda.synchronize()
    kd = got[4].tolist()
    check(kd == ref[4].tolist(), f"K9 k_done {kd} != plain {ref[4].tolist()}")
    check(kd[:3] == [5, 0, 0] and kd[3] >= 1, f"K9 k_done {kd}")
    check(max(kd) <= replays <= max(kd) + WINDOW_LAG,
          f"K9 graph route: {replays} replays for {max(kd)} live iterations")
    check(watch.strips == 0 and watch.gathers == 0,
          f"K9 on one card: {watch.strips} strip exchanges, "
          f"{watch.gathers} coarse gathers or splits")
    check(all(bool(torch.equal(g, h)) for g, h in zip(got, loop)),
          "K9 graph route != host loop")
    k9_err = 0.0
    for nm, g, e in zip(("x", "r", "p", "rz"), got[:4], ref[:4]):
        err = float((g - e).abs().max())
        check(bool(torch.equal(g, e)),
              f"K9 {nm}: max|kernel - plain| {err} (bit-equal expected)")
        k9_err = max(k9_err, err)
    for g, s0 in zip(got[:3], (x4, r4, p4)):
        check(bool(torch.equal(g[1], s0[1])), "K9 frozen image changed")
    phase(26, t0, f"K9 vs plain, B=4 x {C3_SIZE}^2 fp32, SP=4, k=5: k_done "
          f"{kd}, max abs err x/r/p/rz {k9_err:.3e}, bit-equal True; "
          f"graph route ({replays} replays) bit-equal to the host loop in "
          f"x, r, p, rz and k_done; in the kernel's window "
          f"{watch.strips} strip exchanges, {watch.gathers} coarse gathers "
          f"or splits")
    del got, ref, loop

    # -- 27: BASELINE config 3 through sharded_solve_mgcg
    t0 = time.perf_counter()
    d1, c1, s1, x01 = c3_problem(imgs4[0], dev)
    deff14, iters14 = c3_stored
    kw = dict(C3_KW, first_window=0)
    # At 4096^2 the float32 solves stop above relres 1e-4 (mean|b| halves
    # with nx, the rounding floor of mean|b - A x| does not): one float32
    # solve of each engine records where; the timed 4096^2 leg is float64.
    _, c, s, x0 = c3_problem(img4k, dev)
    floor32 = halo.sharded_solve_mgcg(c, s, x0, mesh.make_mesh(
        4, devices=[dev] * 4), **kw)
    floor32_u = multigrid.solve_mgcg(c, s, x0, use_pallas="tiled", **kw)
    # the sharded solve again with the gathered tail forced at level 1, so
    # that K2 runs every level under level 0, as in the unsharded engine
    fits = fused2d.fits_whole_cycle
    fused2d.fits_whole_cycle = lambda *a, **k: True
    try:
        floor32_t = halo.sharded_solve_mgcg(c, s, x0, mesh.make_mesh(
            4, devices=[dev] * 4), **kw)
    finally:
        fused2d.fits_whole_cycle = fits
    phase(27, t0, f"config 3 at {C4K_SIZE}^2 float32 {card}: " + "; ".join(
        f"{nm} {int(r.iters)} iterations, relres {float(r.conv):.3e}, Deff "
        f"{float(r.deff):.6f}" for nm, r in (
            ("sharded SP=4", floor32), ("unsharded banded", floor32_u),
            ("sharded SP=4 with the tail at level 1", floor32_t)))
          + f" (the float32 floor; the timed {C4K_SIZE}^2 leg is float64)")
    t0 = time.perf_counter()
    del c, s, x0, floor32, floor32_u, floor32_t
    main_launches = None
    for name, sp, size in (("SP=4", 4, C3_SIZE), ("SP=1", 1, C3_SIZE),
                           (f"{C4K_SIZE}^2 float64 SP=4", 4, C4K_SIZE)):
        if size == C3_SIZE:
            c, s, x0 = c1, s1, x01
        else:
            _, c, s, x0 = c3_problem(img4k, dev, torch.float64)
        m = mesh.make_mesh(sp, devices=[dev] * sp)
        torch.cuda.synchronize()
        zero_counts()
        cyc0 = lib.deff_image_cycle_count()
        rep0 = cg_steps_sharded.replays
        t1 = time.perf_counter()
        with K9Watch() as watch:
            res = halo.sharded_solve_mgcg(c, s, x0, m, **kw)
            torch.cuda.synchronize()
        t_first = time.perf_counter() - t1
        launched = counts()
        replays = cg_steps_sharded.replays - rep0
        cycles = lib.deff_image_cycle_count() - cyc0
        if main_launches is None:
            main_launches = launched
        check(launched["K9"] > 0 and launched["K8 T1"] > 0
              and launched["K8 T2"] > 0 and launched["K2"] > 0
              and launched["K1"] == launched["K4"] == launched["K5"] == 0,
              f"config 3 {name} launches {launched}")
        conv, deff, iters = float(res.conv), float(res.deff), int(res.iters)
        check(np.isfinite(deff) and conv <= C3_KW["tol"],
              f"config 3 {name}: relres {conv}, Deff {deff}")
        # one gathered K2 tail cycle that does work per live iteration
        # (the device count; the replays after the image died are gated),
        # plus one for the fresh start and one for the refresh after each
        # of the K9 windows
        check(cycles == iters + launched["K9"] + 1,
              f"config 3 {name}: {cycles} K2 image cycles for {iters} live "
              f"iterations and {launched['K9']} windows")
        check(0 < replays <= iters + WINDOW_LAG * launched["K9"],
              f"config 3 {name}: {replays} K9 graph replays for {iters} "
              f"live iterations in {launched['K9']} windows")
        check(watch.strips == 0 and watch.gathers == 0,
              f"config 3 {name}: {watch.strips} strip exchanges and "
              f"{watch.gathers} coarse gathers or splits in K9's windows")
        if size == C3_SIZE:
            plain = halo.sharded_solve_mgcg(c, s, x0, m, plain=True, **kw)
            p_deff, p_iters = float(plain.deff), int(plain.iters)
            rel_p = abs(deff - p_deff) / abs(p_deff)
            check(rel_p <= 1e-4 and abs(iters - p_iters) <= 2,
                  f"config 3 {name} vs plain: Deff {deff} / {p_deff}, "
                  f"iterations {iters} / {p_iters}")
            vs_plain = (f"plain {p_iters} iterations, Deff {p_deff:.6f}, "
                        f"rel err {rel_p:.3e}; ")
            u_deff, u_iters, u_name = deff14, iters14, "phase 14's stored"
        else:
            vs_plain = ""
            u = multigrid.solve_mgcg(c, s, x0, use_pallas="tiled", **kw)
            u_deff, u_iters, u_name = (float(u.deff), int(u.iters),
                                       "the unsharded banded")
        gap = abs(deff - u_deff) / abs(u_deff)
        check(gap <= 1e-3, f"config 3 {name} vs {u_name}: Deff {deff} / "
              f"{u_deff}")
        halo.sharded_solve_mgcg(c, s, x0, m, **kw)              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            halo.sharded_solve_mgcg(c, s, x0, m, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        turns = ""
        if name == "SP=4":
            # the graph route against the host loop, in turns
            def solve(graph):
                t1 = time.perf_counter()
                out = (halo.sharded_solve_mgcg(c, s, x0, m, **kw) if graph
                       else host_loop(lambda: halo.sharded_solve_mgcg(
                           c, s, x0, m, **kw)))
                torch.cuda.synchronize()
                return time.perf_counter() - t1, out
            solve(False)                                        # warm-up
            tt = [solve(g) for g in (True, False, False, True)]
            loop_res = tt[1][1]
            check(float(loop_res.deff) == deff
                  and int(loop_res.iters) == iters,
                  f"config 3 {name} host loop: Deff {float(loop_res.deff)}, "
                  f"{int(loop_res.iters)} iterations")
            turns = (f"; in turns graph, host loop, host loop, graph "
                     f"{', '.join(f'{t:.4f}' for t, _ in tt)} s (the host "
                     f"loop's Deff and iterations equal)")
        phase(27, t0, f"BASELINE config 3 sharded {name} {card}: "
              f"{size}^2, {iters} iterations, relres {conv:.3e}, Deff "
              f"{deff:.6f} ({vs_plain}{u_name} solve {u_iters} iterations, "
              f"Deff {u_deff:.6f}, rel gap {gap:.3e}, iteration gap "
              f"{iters - u_iters:+d}), first run {t_first:.4f} s, timed "
              f"{', '.join(f'{t:.4f}' for t in times)} s, "
              f"{min(times) / iters * 1e3:.4f} ms/iteration, peak memory "
              f"{peak / 2**30:.3f} GiB, launches {launched}, K9 graph "
              f"replays {replays} (at most {iters} + {WINDOW_LAG} a "
              f"window), in K9's windows {watch.strips} strip exchanges and "
              f"{watch.gathers} coarse gathers or splits, K2 image cycles "
              f"(device count) "
              f"{cycles} = {iters} live iterations + {launched['K9'] + 1} "
              f"fresh and refresh{turns}")
        t0 = time.perf_counter()
        del res
    del c, s, x0

    # -- 28: the pipeline routes on the card
    t0 = time.perf_counter()
    results = []
    tables = {}
    for devices in (1, 4):
        csv = WORK_DIR / f"batch_sp_{devices}.csv"
        csv.unlink(missing_ok=True)
        inp = WORK_DIR / f"input_sp_{devices}.txt"
        inp.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: 2\n"
                       f"Ds: {CONTRAST}\nDf: 1\nSolver: mgcg\n"
                       f"Criterion: residual\nConvergence: {C15_TOL}\n"
                       f"MaxIter: 400\nDevices: {devices}\nDP: 1\n"
                       f"SP: {devices}\nOutputName: {csv}\n")
        zero_counts()
        tables[devices] = batch.batch_sim(
            parse_input_file(str(inp)), imgs=list(imgs4[:2]), device="cuda",
            mesh_devices=[dev] * devices)
        torch.cuda.synchronize()
        launched = counts()
        check(bool(np.all(np.isfinite(tables[devices][:, 3]))),
              f"Devices: {devices} Deff not finite")
        if devices == 4:
            check(launched["K9"] > 0 and launched["K5"] == 0,
                  f"SP route launches {launched}")
            sp_launches = launched
    rel_sp = np.abs(tables[4][:, 3] - tables[1][:, 3]) / tables[1][:, 3]
    check(bool(np.all(rel_sp <= 1e-3)), f"SP route Deff rel err {rel_sp}")
    results.append(f"Devices: 4, DP: 1, SP: 4 on two {C3_SIZE}^2 images: Deff "
                   f"{', '.join(f'{v:.6f}' for v in tables[4][:, 3])} vs "
                   f"Devices: 1 {', '.join(f'{v:.6f}' for v in tables[1][:, 3])}"
                   f" (max rel err {rel_sp.max():.3e}), solve "
                   f"{tables[4][:, 4].sum():.3f} s vs "
                   f"{tables[1][:, 4].sum():.3f} s, launches {sp_launches}")
    csv = WORK_DIR / "batch_dp.csv"
    csv.unlink(missing_ok=True)
    inp = WORK_DIR / "input_dp.txt"
    inp.write_text("".join(line + "\n" for line in inp10_text.splitlines()
                           if not line.startswith("OutputName:"))
                   + f"Devices: 2\nDP: 2\nOutputName: {csv}\n")
    zero_counts()
    table_dp = batch.batch_sim(parse_input_file(str(inp)), imgs=list(imgs64),
                               device="cuda", mesh_devices=[dev] * 2)
    torch.cuda.synchronize()
    launched = counts()
    check(launched["K1"] > 0, f"DP route launches {launched}")
    cols = [0, 1, 2, 3, 5, 6, 7, 8]
    rel_dp = np.abs(table_dp[:, cols] - table10[:, cols]) / np.maximum(
        np.abs(table10[:, cols]), 1e-300)
    check(bool(np.all(rel_dp <= 1e-6)), f"DP route vs Devices: 1 rel err "
          f"{rel_dp.max()}")
    results.append(f"Devices: 2, DP: 2 on 64 of phase 5's images: CSV "
                   f"columns but Time vs phase 10's Devices: 1 max rel err "
                   f"{rel_dp.max():.3e}, launches {launched}")
    zero_counts()
    dry = dryrun_multichip([dev] * 4, out_dir=str(WORK_DIR))
    results.append("dryrun twin on 4 shards: " + " | ".join(dry))
    phase(28, t0, "pipeline routes: " + "; ".join(results))

    # -- 29: K8/K9 times (CUDA events), then one profiled sharded solve
    t0 = time.perf_counter()
    times, lines = {}, []
    item = x4.element_size()
    for bsz in (1, 4):
        sub = slice(0, bsz)
        cb = type(c4)(*(a[sub] for a in c4))
        xb = x4[sub].contiguous()
        rb = cb.b - fvm.apply_operator(cb, xb)
        for sp in (4, 1):
            m, hier, cw, tail = sharded_setup(cb, sp, dev, C3_KW["min_size"])
            rs = mesh.shard_rows(m, rb)[0]

            rows = {}

            def cycle(plain=False):
                return fused2d.v_cycle_sharded_fused(hier, cw, rs, tail=tail,
                                                     plain=plain, rows=rows,
                                                     **MG3)

            ms = cuda_ms(cycle, 10, warm=2)
            own = kernel_device_us(cycle, 10, K8_KERNELS)
            ms_p = cuda_ms(lambda: cycle(True), 2)
            bd = bound(*sharded_work(hier, tail, sp, bsz, item, MG3["nu"]),
                       item)
            times[("K8", bsz, sp)] = (ms, ms_p, bd)
            pb = joined(cycle())
            rzb = batch_sum(rb * pb)
            ones = torch.ones(bsz, device=dev)
            zero = torch.zeros(bsz, device=dev)
            inf = torch.full((bsz,), float("inf"), device=dev)

            def k9(fn, plain, reps, graph=True):
                """A K9 call of K9_TIME_K iterations on fresh shards, as
                the solver makes it (``fused2d.k9_coarse``); the kernel
                calls share one workspace (the graph route captures in the
                first, the warm-up) and one coarse callable."""
                states = [[mesh.shard_rows(m, t)[0] for t in (xb, rb, pb)]
                          for _ in range(reps)]
                kw9 = fused2d.k9_coarse(hier, cw, states[0][0], tail=tail,
                                        plain=plain, **MG3)

                def call():
                    xs, rs_, ps = states.pop()
                    if not plain and "workspace" not in kw9:
                        kw9["workspace"] = ShardWorkspace(
                            cw[0], xs, graph, kw9.get("coarse_plane"))
                    fn(cw[0], xs, rs_, ps, rzb, ones, zero, inf, K9_TIME_K,
                       omega=MG3["omega"], nu=MG3["nu"], over=MG3["over"],
                       **kw9)
                return call

            n0 = lib.deff_launch_count()
            k9(cg_steps_sharded, False, 1, graph=False)()
            per_iter = (lib.deff_launch_count() - n0) / K9_TIME_K
            # the graph route and the host loop in turns
            tt = [cuda_ms(k9(cg_steps_sharded, False, 4, graph=g), 3)
                  for g in (True, False, False, True)]
            ms9, ms9_loop = min(tt[0], tt[3]), min(tt[1], tt[2])
            passes = [kernel_device_us(k9(cg_steps_sharded, False, 3), 2,
                                       (frag,))
                      for frag in K9_PASSES]
            ms9_p = cuda_ms(k9(cg_steps_sharded_reference, True, 2), 1)
            bd9 = bound(*sharded_work(hier, tail, sp, bsz, item, MG3["nu"],
                                      K9_TIME_K), item)
            times[("K9", bsz, sp)] = (ms9, ms9_p, bd9)
            lines.append(
                f"B={bsz} SP={sp}: K8 cycle {ms:.4f} ms (device "
                f"{k8_own_text(own)}; plain {ms_p:.4f} ms, bound "
                f"{bd[0]:.4f} ms by {bd[1]}); K9 k={K9_TIME_K} "
                f"graph route {ms9:.4f} ms ({ms9 / K9_TIME_K:.4f} "
                f"ms/iteration), host loop {ms9_loop:.4f} ms "
                f"({ms9_loop / K9_TIME_K:.4f}; turns graph, loop, loop, "
                f"graph {', '.join(f'{t:.4f}' for t in tt)} ms); plain "
                f"{ms9_p:.4f} ms, bound {bd9[0]:.4f} ms by {bd9[1]}, "
                f"{per_iter:g} library launches/iteration; device "
                + (", ".join(f"pass {nm} {us[0] / 1e3:.4f} ms" for nm, us in
                             zip("PXZ", passes)) + f" of {passes[0][1] / 1e3:.4f}"
                   if all(passes) else "not measured"))
            del hier, cw, tail, rs, pb, rows
    phase(29, t0, f"K8/K9 times {card}, {C3_SIZE}^2 fp32: " + "; ".join(lines))
    t0 = time.perf_counter()
    m = mesh.make_mesh(4, devices=[dev] * 4)
    prof = profile_solve(
        lambda: halo.sharded_solve_mgcg(c1, s1, x01, m, **C3_KW,
                                        first_window=0),
        PROFILE_GROUPS_SHARDED)
    if prof is None:
        line = "the profiler saw no device time"
    else:
        busy, span, wall, groups = prof
        line = (f"device busy {busy:.3f} ms of a {span:.3f} ms kernel span "
                f"(idle share {1 - busy / span:.1%}; wall {wall:.3f} ms under "
                "the profiler), by group " + ", ".join(
                    f"{g} {ms:.3f} ms ({ms / busy:.0%})" for g, ms in
                    sorted(groups.items(), key=lambda kv: -kv[1])))
    phase(29, t0, f"config 3 sharded SP=4 profile {card}: {line}")

    k8_ms, k8_ms_p, k8_bound = times[("K8", 1, 4)]
    k9_ms, k9_ms_p, k9_bound = times[("K9", 1, 4)]
    return [
        {"name": "v_cycle_sharded_fused (shard_row_t1, shard_row_t2)",
         "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/vcycle_sharded.cu",
         "replaces": "effectivediffusivityfvm_tpu/parallel/fused2d.py:358",
         "launches": main_launches["K8 T1"] + main_launches["K8 T2"],
         "max_abs_err": k8_err, "ms": k8_ms, "plain_ms": k8_ms_p,
         "bound_ms": k8_bound[0], "bound_by": k8_bound[1],
         "library_ms": None},
        {"name": "cg_steps_sharded", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/cgstep_sharded.cu",
         "replaces": "effectivediffusivityfvm_tpu/parallel/fused2d_cg.py:389",
         "launches": main_launches["K9"], "max_abs_err": k9_err,
         "ms": k9_ms, "plain_ms": k9_ms_p, "bound_ms": k9_bound[0],
         "bound_by": k9_bound[1], "library_ms": None},
    ]


# -- phases 30-35: the Krylov solvers (slice 3)
CG3_KW = dict(tol=1e-8, max_iter=20_000, check_every=500,
              criterion="relresidual")          # bench_configs.py:157
C2_SIZE, C2_SEED = 512, 2
C2_KW = dict(tol=1e-5, max_iter=400_000, check_every=10_000,
             criterion="deff")                  # bench_configs.py:76
DMG3_KW = dict(tol=1e-8, max_iter=600, check_every=20,
               criterion="relresidual", min_size=32,
               coarse_iters=64)                 # bench_configs.py:142
DMG_K2_SIZE = 1024                              # phase 32's forced-K2 leg
DEMO_SHAPE, DEMO_SEED = (2007, 1002), 13        # the reference demo's size
DEMO_DG = 1237500.0
DEMO_MAX_ITER = 3000
B34, N34 = 4, 256                               # phase 34's batch
# phase 34's gas diffusivity by solver: cgir's float32 inner CG stalls at
# its 8000-iteration cap on these media from the second outer step on, so
# it runs at Dg = 10 (three outer steps); dcg walks two homotopy
# pre-stages at Dg = 1000, which dmg skips
DG34 = {"dcg": 1000.0, "cgir": 10.0, "dmg": 1000.0}
C5_SLICE = 64                                   # phase 35's CLI volumes
PROFILE_GROUPS_DMG = (
    ("K4 T1/T2", ("BandedLeg",)),
    ("K4's K2 tail", K2_KERNELS),
)


def grayscale_field(rng, n, sigma=6.0):
    """bench_configs.py's config-2 generator: Gaussian-smoothed noise
    scaled to 0..255 (pixel value -> per-pixel D)."""
    from scipy import ndimage

    noise = ndimage.gaussian_filter(rng.standard_normal((n, n)), sigma=sigma)
    lo, hi = noise.min(), noise.max()
    return ((noise - lo) / (hi - lo) * 255).astype(np.uint8)


def blob_image(shape, seed, gas, solid):
    """A 3-phase image in the style of tests/test_cg.py's gas blobs, scaled
    up: fluid (150) with gas discs (0) and then solid discs (255); ``gas``
    and ``solid`` are ``(count, (r_min, r_max))``, the gas discs drawn from
    ``default_rng(seed)``, the solid ones from ``default_rng(seed + 100)``.
    Discs may cross the image's edges, the Dirichlet columns included."""
    ny, nx = shape
    img = np.full(shape, 150, np.uint8)
    for value, (count, radii), rng in (
            (0, gas, np.random.default_rng(seed)),
            (255, solid, np.random.default_rng(seed + 100))):
        for _ in range(count):
            r = int(rng.integers(*radii))
            ci, cj = int(rng.integers(0, ny)), int(rng.integers(0, nx))
            i0, i1 = max(ci - r, 0), min(ci + r + 1, ny)
            j0, j1 = max(cj - r, 0), min(cj + r + 1, nx)
            ii, jj = np.ogrid[i0:i1, j0:j1]
            sub = img[i0:i1, j0:j1]
            sub[(ii - ci) ** 2 + (jj - cj) ** 2 < r * r] = value
    return img


def write_png(path, img):
    """A lossless 8-bit grayscale PNG (filter 0, zlib), written without
    PIL."""
    import struct
    import zlib

    ny, nx = img.shape

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(ny))
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", nx, ny, 8, 0,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw, 6))
                     + chunk(b"IEND", b""))


def direct_deff(coeffs, spec):
    """Deff of a scipy float64 direct solve of the system ``coeffs`` (one
    image, moved to the host in float64)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from effectivediffusivityfvm_tpu_torch.ops.flux import boundary_deff

    ny, nx = coeffs.diag.shape

    def flat(t):
        return t.detach().to("cpu", torch.float64).numpy().ravel()

    a = sp.diags([flat(coeffs.diag), -flat(coeffs.a_w)[1:],
                  -flat(coeffs.a_e)[:-1], -flat(coeffs.a_n)[nx:],
                  -flat(coeffs.a_s)[:-nx]], [0, -1, 1, -nx, nx],
                 format="csc")
    x = spla.spsolve(a, flat(coeffs.b)).reshape(ny, nx)
    spec64 = type(spec)(*(t.detach().to("cpu", torch.float64) for t in spec))
    return float(boundary_deff(spec64, torch.from_numpy(x)))


def observe(module, name, seen):
    """Wrap ``module.name`` so that each call's result is appended to
    ``seen``; returns the original (put it back when done)."""
    fn = getattr(module, name)

    def run(*a, **kw):
        out = fn(*a, **kw)
        seen.append(out)
        return out
    setattr(module, name, run)
    return fn


def krylov_phases(dev, card, lib):
    """Phases 30-35: the Krylov solvers on the card."""
    import torch

    from effectivediffusivityfvm_tpu_torch import cli
    from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
    from effectivediffusivityfvm_tpu_torch.models import phases
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.flux import (deff_flux_average,
                                                            make_flux_spec)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import v_cycle
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_tiled import \
        v_cycle_tiled
    from effectivediffusivityfvm_tpu_torch.pipeline import batch, single
    from effectivediffusivityfvm_tpu_torch.pipeline import volume as pvol
    from effectivediffusivityfvm_tpu_torch.solvers import (cg, deflation,
                                                           dmg, rbsor,
                                                           solvers3d)

    def zero_counts():
        v_cycle.launches = v_cycle_tiled.launches = 0

    def counts():
        return {"K2": v_cycle.launches, "K4": v_cycle_tiled.launches}

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    # -- 30: config 3's cg leg (bench_configs.py:104-110, 150-161)
    t0 = time.perf_counter()
    rng = np.random.default_rng(C3_SEED)
    img3 = correlated_binary(rng, C3_SIZE, C3_SIZE)
    d3, c3, s3, x03 = c3_problem(img3, dev)
    first = cg.solve_cg(c3, s3, x03, **dict(CG3_KW, max_iter=1))
    res, secs = timed(lambda: cg.solve_cg(c3, s3, x03, **CG3_KW))
    its, relres, deff = int(res.iters), float(res.conv), float(res.deff)
    windows = 1 + -(-(its - 1) // CG3_KW["check_every"])
    diverged = its < CG3_KW["max_iter"] and relres > CG3_KW["tol"]
    check(np.isfinite(relres) and np.isfinite(deff), f"cg relres {relres}, "
          f"Deff {deff}")
    check(not diverged, f"cg stopped at {its} iterations with relres "
          f"{relres}: the divergence net fired")
    check(relres < float(first.conv), f"cg relres {relres} not below the "
          f"first check's {float(first.conv)}")
    phase(30, t0, f"config 3 cg {card}: {C3_SIZE}^2 fp32, {its} iterations, "
          f"relres {relres:.3e} (first check {float(first.conv):.3e}), Deff "
          f"{deff:.6f}, {secs:.3f} s, {windows} windows "
          f"({secs / its * 1e3:.4f} ms/iteration)")
    del c3, s3, x03, res, first

    # -- 31: BASELINE config 2 (bench_configs.py:60-90)
    t0 = time.perf_counter()
    n = C2_SIZE
    img2 = grayscale_field(np.random.default_rng(C2_SEED), n)
    d2 = torch.tensor(10.0 ** (-3.0 * (1.0 - img2 / 255.0)),
                      dtype=torch.float32, device=dev)
    c2 = fvm.fvm_coefficients(d2, 0.0, 1.0)
    s2 = make_flux_spec(d2, 0.0, 1.0)
    x02 = (torch.arange(n, dtype=torch.float32, device=dev) / n).expand(n, n)
    res, secs = timed(lambda: rbsor.solve_rbsor(c2, s2, x02, **C2_KW))
    sweeps, deff2 = int(res.iters), float(res.deff)
    t1 = time.perf_counter()
    d2_64 = d2.double().cpu()
    want = direct_deff(fvm.fvm_coefficients(d2_64, 0.0, 1.0),
                       make_flux_spec(d2_64, 0.0, 1.0))
    t_direct = time.perf_counter() - t1
    rel2 = abs(deff2 - want) / abs(want)
    check(rel2 <= 1e-3, f"config 2 Deff {deff2} vs direct {want}: rel err "
          f"{rel2}")
    phase(31, t0, f"config 2 rbsor {card}: {n}^2 fp32, omega "
          f"{rbsor.omega_opt(n, n):.6f}, {sweeps} sweeps, Deff {deff2:.6f}, "
          f"conv {float(res.conv):.3e}, {secs:.3f} s, "
          f"{sweeps * n * n / secs / 1e9:.3f} Gcell-iters/s; scipy float64 "
          f"direct solve Deff {want:.6f} ({t_direct:.1f} s on the host), rel "
          f"err {rel2:.3e}")
    del c2, s2, x02, res

    # -- 32: config 3's dmg leg (bench_configs.py:130-148) on K4, then at
    # 1024^2 on K2 (forced)
    t0 = time.perf_counter()
    lines = []
    dmg_launches = {}
    for size, use_pallas in ((C3_SIZE, None), (DMG_K2_SIZE, True)):
        img = img3 if size == C3_SIZE else correlated_binary(
            np.random.default_rng(C3_SEED), size, size)
        d64, c64, s64, x064 = c3_problem(img, dev, torch.float64)
        route = (dmg._dmg_engine_auto((size, size), torch.float32, 2)
                 if use_pallas is None else use_pallas)
        check(route == ("tiled" if size == C3_SIZE else True),
              f"dmg route at {size}^2: {route!r}")
        kw = dict(DMG3_KW, use_pallas=use_pallas)
        zero_counts()
        res, first_s = timed(lambda: dmg.solve_dmg(c64, s64, x064, **kw))
        per_solve = counts()
        key = "K4" if route == "tiled" else "K2"
        check(per_solve[key] > 0 and sum(per_solve.values())
              == per_solve[key], f"dmg {size}^2 launches {per_solve}")
        dmg_launches[key] = per_solve[key]
        times = [timed(lambda: dmg.solve_dmg(c64, s64, x064, **kw))[1]
                 for _ in range(3)]
        plain = dmg.solve_dmg(c64, s64, x064, plain=True, **kw)
        d_it = abs(int(res.iters) - int(plain.iters))
        rel = abs(float(res.deff) - float(plain.deff)) / abs(float(
            plain.deff))
        check(d_it <= 2 and rel <= 1e-6, f"dmg {size}^2 vs plain: "
              f"iterations {int(res.iters)} vs {int(plain.iters)}, Deff rel "
              f"err {rel}")
        line = (f"{size}^2 f64 on {key} ({'auto' if use_pallas is None else 'forced'}): "
                f"{int(res.iters)} iterations, relres {float(res.conv):.3e}, "
                f"Deff {float(res.deff):.6f}, best of 3 {min(times):.4f} s "
                f"(runs {', '.join(f'{t:.4f}' for t in times)}; first "
                f"{first_s:.3f} s), {per_solve[key]} {key} launches a solve; "
                f"vs plain: iterations {int(plain.iters)}, Deff rel err "
                f"{rel:.3e}")
        if route == "tiled":
            prof = profile_solve(lambda: dmg.solve_dmg(c64, s64, x064, **kw),
                                 PROFILE_GROUPS_DMG)
            line += f"; profile: {profile_line(prof)}"
        lines.append(line)
        del d64, c64, s64, x064, res, plain
    phase(32, t0, f"config 3 dmg {card}: " + "; ".join(lines))

    # -- 33: the reference demo's setting through the CLI
    t0 = time.perf_counter()
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    demo = blob_image(DEMO_SHAPE, DEMO_SEED, gas=(60, (32, 160)),
                      solid=(40, (8, 40)))
    png = WORK_DIR / "demo.png"
    write_png(png, demo)
    csv = WORK_DIR / "demo.csv"
    inp = WORK_DIR / "input_demo.txt"
    inp.write_text(f"Phases: 3\nInputName: {png}\nDs: 0\nDf: 1\n"
                   f"Dg: {DEMO_DG:.0f}\nDtype: float64\nSolver: dmg\n"
                   f"Criterion: relresidual\nConvergence: 1e-10\n"
                   f"MaxIter: {DEMO_MAX_ITER}\nVerbose: 1\n"
                   f"OutputName: {csv}\n")
    csv.unlink(missing_ok=True)
    zero_counts()
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "effectivediffusivityfvm_tpu_torch.cli",
         str(inp)], cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=600)
    wall_cli = time.perf_counter() - t1
    check(proc.returncode == 0, f"the CLI returned {proc.returncode}: "
          f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    taken = re.findall(r"Iterations taken = (\d+)", proc.stdout)
    row = csv.read_text().splitlines()[1].split(",")
    # the same run in this process, to read the field and the space
    spaces, results = [], []
    build = observe(dmg, "build_component_deflation", spaces)
    solve3p = observe(single, "single_sim_3phase", results)
    cli.single_sim_3phase = single.single_sim_3phase
    try:
        rc = cli.main([str(inp)], device=dev)
        torch.cuda.synchronize()
    finally:
        dmg.build_component_deflation = build
        single.single_sim_3phase = cli.single_sim_3phase = solve3p
    l_demo = counts()
    check(rc == 0 and len(results) == 1 and len(spaces) == 1,
          f"cli.main returned {rc}")
    r33 = results[0]
    m = spaces[0].m if spaces[0] is not None else 0
    classes = phases.three_phase_classes(demo)
    d_demo = torch.tensor(phases.d_field_from_classes(
        classes, 1.0, 0.0, DEMO_DG, dtype=np.float64))
    avg = float(deff_flux_average(d_demo, torch.from_numpy(r33.x), 0.0,
                                  1.0))
    gap = abs(r33.deff - avg) / abs(avg)
    check(r33.conv <= 1e-10, f"demo relres {r33.conv} after {r33.iters} "
          "iterations")
    check(gap <= 1e-4, f"demo boundary Deff {r33.deff} vs all-cuts "
          f"{avg}: {gap}")
    check(l_demo["K4"] > 0, f"demo launches {l_demo}")
    check(taken and int(taken[-1]) == r33.iters and abs(
        float(row[4]) - r33.deff) <= 1e-3 * abs(r33.deff),
          f"the CLI run: iterations {taken}, CSV {row}")
    phase(33, t0, f"demo setting via the CLI {card}: {DEMO_SHAPE[0]}x"
          f"{DEMO_SHAPE[1]} 3-phase, Dg {DEMO_DG:.0f}, f64 dmg, m {m} "
          f"components, {r33.iters} iterations, relres {r33.conv:.3e}, Deff "
          f"{r33.deff:.6f} (all-cuts {avg:.6f}, gap {gap:.3e}), solve "
          f"{r33.time_s:.3f} s; {l_demo['K4']} K4 launches; the "
          f"`python -m ...cli` run {wall_cli:.1f} s wall, CSV Deff {row[4]}, "
          f"conv {row[7]}")
    del d_demo, results

    # -- 34: the batch and mesh routes, eight 256^2 3-phase images
    t0 = time.perf_counter()
    imgs34 = [blob_image((N34, N34), 40 + i, gas=(24, (4, 20)),
                         solid=(8, (4, 20))) for i in range(B34)]
    lines, tables = [], {}
    for solver in ("dcg", "cgir", "dmg"):
        cfg = SimulationConfig(
            n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=DG34[solver],
            dtype="float64", solver=solver, criterion="relresidual",
            convergence=1e-10, max_iter=20 if solver == "cgir" else 5000,
            output_name=str(WORK_DIR / f"batch34_{solver}.csv"))
        Path(cfg.output_name).unlink(missing_ok=True)
        zero_counts()
        table, secs = timed(lambda: batch.batch_sim_3phase(
            cfg, imgs=list(imgs34), device=dev))
        l34 = counts()
        tables[solver] = table
        singles = np.array([single.single_sim_3phase(
            cfg, img=im, write_output=False, device=dev).deff
            for im in imgs34])
        rel = np.abs(table[:, 4] - singles) / np.abs(singles)
        check(bool(np.all(rel <= 1e-8)), f"{solver} batch vs single Deff rel "
              f"err {rel.max()}")
        check(bool(np.all(table[:, 7] <= 1e-10)), f"{solver} batch conv "
              f"{table[:, 7].max()}")
        if solver == "dmg":
            check(l34["K2"] > 0, f"dmg batch launches {l34}")
        lines.append(f"{solver} (Dg {DG34[solver]:.0f}): batch {secs:.3f} s, "
                     f"Deff {table[:, 4].min():.4f}"
                     f"..{table[:, 4].max():.4f}, max conv "
                     f"{table[:, 7].max():.3e}, vs single solves max rel err "
                     f"{rel.max():.3e}" + (f", K2 launches {l34['K2']}"
                                           if solver == "dmg" else ""))
    cfg_dp = SimulationConfig(
        n_phase=3, d_fluid=1.0, d_solid=0.0, d_gas=DG34["dmg"],
        dtype="float64", solver="dmg", criterion="relresidual", convergence=1e-10,
        max_iter=5000, devices=2, dp=2,
        output_name=str(WORK_DIR / "batch34_dmg_dp.csv"))
    Path(cfg_dp.output_name).unlink(missing_ok=True)
    table_dp = batch.batch_sim_3phase(
        cfg_dp, imgs=list(imgs34), device=dev,
        mesh_devices=[torch.device(dev)] * 2)
    rel = (np.abs(table_dp[:, 4] - tables["dmg"][:, 4])
           / np.abs(tables["dmg"][:, 4]))
    check(bool(np.all(rel <= 1e-8)), f"dmg DP route vs batch rel err "
          f"{rel.max()}")
    lines.append(f"dmg Devices 2 DP 2 on cuda:0 twice vs the batch: max rel "
                 f"err {rel.max():.3e}")
    phase(34, t0, f"batch routes {card}, {B34} x {N34}^2 3-phase f64: "
          + "; ".join(lines))

    # -- 35: 3D: config 5's volume through solve_cg_3d, then a 64^3 slice
    # of it through the .npy CLI with rbsor and cg
    t0 = time.perf_counter()
    fluid5 = c5_fluid((C5_SIZE,) * 3, C5_SEED)
    d5, c5, s5, x05 = c5_problem(fluid5, dev)
    res, secs = timed(lambda: solvers3d.solve_cg_3d(
        c5, s5, x05, tol=1e-4, max_iter=2000, check_every=100,
        criterion="relresidual"))
    check(np.isfinite(float(res.conv)) and np.isfinite(float(res.deff)),
          f"3D cg relres {float(res.conv)}")
    line = (f"{C5_SIZE}^3 fp32 solve_cg_3d: {int(res.iters)} iterations, "
            f"relres {float(res.conv):.3e}, Deff {float(res.deff):.6f}, "
            f"{secs:.3f} s")
    del d5, c5, s5, x05, res
    vol = np.where(fluid5[:C5_SLICE, :C5_SLICE, :C5_SLICE], 0,
                   255).astype(np.uint8)
    np.save(WORK_DIR / "vol64.npy", vol)
    got = {}
    for solver in ("rbsor", "cg"):
        inp = WORK_DIR / f"input_vol64_{solver}.txt"
        out = WORK_DIR / f"vol64_{solver}.csv"
        out.unlink(missing_ok=True)
        inp.write_text(f"Phases: 2\nInputName: {WORK_DIR / 'vol64.npy'}\n"
                       f"Ds: {CONTRAST}\nDf: 1\nSolver: {solver}\n"
                       f"Dtype: float64\nCriterion: relresidual\n"
                       f"Convergence: 1e-8\nCheckEvery: 500\n"
                       f"MaxIter: 200000\nOutputName: {out}\n")
        seen = []
        volume_sim = observe(pvol, "volume_sim", seen)
        try:
            t1 = time.perf_counter()
            rc = cli.main([str(inp)], device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            pvol.volume_sim = volume_sim
        check(rc == 0 and len(seen) == 1, f"the {solver} volume CLI run "
              f"returned {rc}")
        got[solver] = seen[0]
        line += (f"; {C5_SLICE}^3 f64 {solver} via the CLI: Deff "
                 f"{seen[0].deff:.6f}, conv {seen[0].conv:.3e}, "
                 f"{seen[0].iters} iterations, solve {seen[0].time_s:.3f} s "
                 f"({wall:.1f} s wall)")
    rel = abs(got["rbsor"].deff - got["cg"].deff) / abs(got["cg"].deff)
    check(rel <= 1e-3, f"3D rbsor Deff {got['rbsor'].deff} vs cg "
          f"{got['cg'].deff}")
    phase(35, t0, f"3D {card}: {line}; rbsor vs cg rel err {rel:.3e}")
    return dmg_launches



# -- phases 36-40: the rest of the solver matrix and native preprocessing
DMG3D_SIZE, DMG3D_DG = 256, 1000.0              # phase 36's volume, Dg
# 100 iterations: the 256^3 medium needs more than 600 to reach 1e-10
# (relres 1.329e-05 at 600 on an NVIDIA H100 80GB HBM3 at 700 W), so the
# phase reports its cap and holds the relres there to DMG3D_CAP_RELRES
# (3.273e-04 at 100 on that card); the JAX package's solve has the port's
# residual history on a 64^3 copy (tests/solver_matrix_witness.py)
DMG3D_KW = dict(tol=1e-10, max_iter=100, check_every=10,
                criterion="relresidual")
DMG3D_CAP_RELRES = 1e-3
C4_SIZE, C4_BATCH, C4_SEED = 512, 256, 4        # bench_configs.py config 4
C4_KW = dict(tol=1e-6, max_iter=3000, check_every=10, criterion="residual",
             min_size=16, coarse_iters=32, nu1=2, nu2=2, over=1.8)
C4_SEGMENT = 50
SH_SHAPE = (2044, 2048)                         # phase 38: 511-row shards
SH_SMALL = (24, 96)                             # phase 38: 6-row shards
H3D_CG_CAP, H3D_JAC_CAP = 200, 300              # phase 39's caps
K6_SPLIT_SIZES = (16, 32, 64, 96, 128, 192, 256)  # phase 36: whole vs banded
K6_SPLIT_BATCHES = (1, 8)
NATIVE_BATCH, NATIVE_SIZE = 256, 128            # phase 40: the CLI batch


def gas_volume(fluid, seed, count=48, radii=(6, 20)):
    """A 3-phase volume from a config-5 fluid mask: fluid 150, solid 255,
    then gas balls (0) from ``default_rng(seed)``, a quarter of them
    centred on each Dirichlet face (x = 0 and x = nx - 1)."""
    rng = np.random.default_rng(seed)
    vol = np.where(fluid, 150, 255).astype(np.uint8)
    nz, ny, nx = vol.shape
    for k in range(count):
        r = int(rng.integers(*radii))
        c = [int(rng.integers(0, n)) for n in (nz, ny, nx)]
        if k % 4 == 0:
            c[2] = 0
        elif k % 4 == 1:
            c[2] = nx - 1
        lo = [max(v - r, 0) for v in c]
        hi = [min(v + r + 1, n) for v, n in zip(c, (nz, ny, nx))]
        kk, ii, jj = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        sub = vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        sub[(kk - c[0]) ** 2 + (ii - c[1]) ** 2 + (jj - c[2]) ** 2
            < r * r] = 0
    return vol


def k6_cycle_split(dev, sizes=K6_SPLIT_SIZES, batches=K6_SPLIT_BATCHES,
                   reps=10):
    """One dmg3d preconditioner cycle (``dmg3d._cycle3``: the float32 raw
    operator, its level tables built once) on K6's whole and banded routes,
    in ms a call by CUDA events, on config 5's medium at each ``n^3`` of
    ``sizes`` and each batch of ``batches``: ``{(bsz, n): (whole,
    banded)}``, the numbers ``dmg3d._dmg3d_engine_auto`` is set from."""
    import torch

    from effectivediffusivityfvm_tpu_torch.ops.fvm3d import StencilCoeffs3D
    from effectivediffusivityfvm_tpu_torch.solvers import dmg3d

    out = {}
    mg = dict(nu=2, mg_omega=0.8, coarse_iters=32, min_size=4, over=1.8,
              plain=False)
    for bsz in batches:
        for n in sizes:
            if bsz * n ** 3 > 256 ** 3:
                continue
            fluid = np.stack([c5_fluid((n,) * 3, C5_SEED + b)
                              for b in range(bsz)])
            _, c, _, _ = c5_problem(fluid, dev)
            raw = StencilCoeffs3D(*(a.to(torch.float32) for a in c))
            r = torch.randn(raw.b.shape, generator=torch.Generator(
                device=dev).manual_seed(n), device=dev)
            times = []
            for engine in (True, "tiled3d"):
                cycle = dmg3d._cycle3(raw, engine, **mg)
                times.append(cuda_ms(lambda: cycle(r), reps))
                del cycle
            out[(bsz, n)] = tuple(times)
            del c, raw, r
            torch.cuda.empty_cache()
    return out


def solver_matrix_phases(dev, card, lib):
    """Phases 36-40: 3D dmg on K6, the compacting batch solve on K1/K2, the
    sharded MGCG routes under run_pcg (K2, and K8 where a band exists), the
    z-slab sharded 3D solvers (K6 tail) and the native preprocessing.
    Returns the new paths' launch counts."""
    import torch

    from effectivediffusivityfvm_tpu_torch import cli
    from effectivediffusivityfvm_tpu_torch.config import parse_input_file
    from effectivediffusivityfvm_tpu_torch.models import (_native, floodfill,
                                                          phases, volume)
    from effectivediffusivityfvm_tpu_torch.ops import fvm, fvm3d
    from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import cg_steps
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import v_cycle
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle3d import (
        v_cycle3d, v_cycle3d_tiled)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_sharded import (
        shard_row_t1, shard_row_t2)
    from effectivediffusivityfvm_tpu_torch.parallel import halo, halo3d
    from effectivediffusivityfvm_tpu_torch.parallel.dryrun import \
        dryrun_multichip
    from effectivediffusivityfvm_tpu_torch.parallel.mesh import make_mesh
    from effectivediffusivityfvm_tpu_torch.pipeline import batch
    from effectivediffusivityfvm_tpu_torch.pipeline import volume as pvol
    from effectivediffusivityfvm_tpu_torch.solvers import (compact, dispatch,
                                                           dmg3d, multigrid,
                                                           solvers3d)

    wrappers = {"K1": cg_steps, "K2": v_cycle, "K6 whole": v_cycle3d,
                "K6 banded": v_cycle3d_tiled, "K8 T1": shard_row_t1,
                "K8 T2": shard_row_t2}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    launches = {}
    WORK_DIR.mkdir(parents=True, exist_ok=True)

    # -- 36: 3D dmg on K6, bench3d.py's medium with gas balls through both
    # Dirichlet faces, f64 (the cycle f32 on K6's whole route, which
    # k6_cycle_split times against the banded one)
    t0 = time.perf_counter()
    split = k6_cycle_split(dev)
    split_text = ", ".join(f"B={b} {n}^3 {w:.4f}/{t:.4f}"
                           for (b, n), (w, t) in split.items())
    n = DMG3D_SIZE
    vol = gas_volume(c5_fluid((n,) * 3, C5_SEED), C5_SEED)
    classes = phases.three_phase_classes(vol)
    ff = volume.flood_fill_3d(vol > 200)
    mask = (vol > 200) | ff.isolated
    gas = (classes == phases.GAS) & ~mask
    d = torch.tensor(phases.d_field_from_classes(
        classes, 1.0, 0.0, DMG3D_DG, dtype=np.float64), device=dev)
    c = fvm3d.fvm_coefficients_3d(d, 0.0, 1.0, mask=torch.as_tensor(
        mask, device=dev), symmetric=True)
    s = fvm3d.make_flux_spec_3d(d, 0.0, 1.0)
    x0 = (torch.arange(n, dtype=torch.float64, device=dev) / n).expand(
        (n,) * 3)
    route = dmg3d._dmg3d_engine_auto((n,) * 3, torch.float32, 2)
    key = "K6 banded" if route == "tiled3d" else "K6 whole"
    (defl, t_space) = timed(lambda: dmg3d.build_component_deflation_3d(
        c, gas))
    kw = dict(DMG3D_KW, defl=defl)
    zero_counts()
    res, secs = timed(lambda: dmg3d.solve_dmg_3d(c, s, x0, **kw))
    l36 = counts()
    check(l36[key] > 0, f"dmg3d launches {l36}")
    plain = dmg3d.solve_dmg_3d(c, s, x0, plain=True, **kw)
    d_it = abs(int(res.iters) - int(plain.iters))
    r_p = rel(res.deff, plain.deff)
    check(d_it <= 2 and r_p <= 1e-6, f"dmg3d vs plain: iterations "
          f"{int(res.iters)} vs {int(plain.iters)}, Deff rel err {r_p}")
    relres = float(res.conv)
    capped = int(res.iters) >= DMG3D_KW["max_iter"]
    check(relres <= 1e-10 or (capped and relres <= DMG3D_CAP_RELRES),
          f"dmg3d relres {relres} after {int(res.iters)} iterations")
    prof = profile_solve(lambda: dmg3d.solve_dmg_3d(c, s, x0, **kw),
                         PROFILE_GROUPS_3D)
    launches["dmg3d"] = l36[key]
    line = (f"{n}^3 3-phase f64, Dg {DMG3D_DG:.0f}, m {defl.m} components "
            f"(space built in {t_space:.2f} s), cycle {route!r}: "
            f"{int(res.iters)} iterations{' (the cap)' if capped else ''}, "
            f"relres {relres:.3e}, Deff {float(res.deff):.6f}, {secs:.3f} s, "
            f"{l36[key]} {key} launches (K6 whole {l36['K6 whole']}); vs "
            f"plain: iterations {int(plain.iters)}, Deff rel err {r_p:.3e}; "
            f"profile: {profile_line(prof)}; one cycle, K6 whole/banded ms: "
            f"{split_text}")
    del res, plain, c, s, d, x0, defl
    torch.cuda.empty_cache()
    npy = WORK_DIR / "vol_dmg3d.npy"
    np.save(npy, vol)
    csv = WORK_DIR / "vol_dmg3d.csv"
    csv.unlink(missing_ok=True)
    inp = WORK_DIR / "input_vol_dmg3d.txt"
    inp.write_text(f"Phases: 3\nInputName: {npy}\nDs: 0\nDf: 1\n"
                   f"Dg: {DMG3D_DG:.0f}\nDtype: float64\nSolver: dmg\n"
                   f"Criterion: relresidual\nConvergence: 1e-10\n"
                   f"CheckEvery: 10\nMaxIter: {DMG3D_KW['max_iter']}\n"
                   f"OutputName: {csv}\n")
    seen = []
    sim = observe(pvol, "volume_sim_3phase", seen)
    try:
        zero_counts()
        rc, wall = timed(lambda: cli.main([str(inp)], device=dev))
    finally:
        pvol.volume_sim_3phase = sim
    l_cli = counts()
    check(rc == 0 and len(seen) == 1 and l_cli[key] > 0,
          f"the dmg .npy CLI run returned {rc}, launches {l_cli}")
    row = csv.read_text().splitlines()[1].split(",")
    check(abs(float(row[4]) - seen[0].deff) <= 1e-4 * abs(seen[0].deff),
          f"the dmg .npy CSV row {row}")
    phase(36, t0, f"dmg3d {card}: {line}; the .npy CLI run: "
          f"{seen[0].iters} iterations, relres {seen[0].conv:.3e}, Deff "
          f"{seen[0].deff:.6f}, solve {seen[0].time_s:.3f} s ({wall:.1f} s "
          f"wall), {l_cli[key]} {key} launches")
    del seen, vol, classes, mask, gas

    # -- 37: Compact: 1 on config 4 (bench_configs.py:169-204), B=256
    t0 = time.perf_counter()
    rng = np.random.default_rng(C4_SEED)
    imgs4 = np.stack([correlated_binary(rng, C4_SIZE, C4_SIZE, sigma=4.0)
                      for _ in range(C4_BATCH)])
    _, c4, s4, x04 = c3_problem(imgs4, dev)
    zero_counts()
    ref, t_plain = timed(lambda: multigrid.solve_mgcg_batched(c4, s4, x04,
                                                              **C4_KW))
    l_plain = counts()
    subs = []

    def recorded(coeffs, spec, x, **kw):
        subs.append(int(x.shape[0]))
        return multigrid.solve_mgcg_batched(coeffs, spec, x, **kw)

    zero_counts()
    got, t_comp = timed(lambda: compact.solve_batched_compacted(
        recorded, c4, s4, x04, segment=C4_SEGMENT, **C4_KW))
    l_comp = counts()
    conv = got.conv.cpu().numpy()
    r_c = np.abs(got.deff.cpu().numpy() - ref.deff.cpu().numpy()) / np.abs(
        ref.deff.cpu().numpy())
    check(bool(np.all(conv <= C4_KW["tol"])), f"compacted conv {conv.max()}")
    check(bool(np.all(r_c <= 1e-4)), f"compacted vs unsegmented Deff rel "
          f"err {r_c.max()}")
    check(l_comp["K1"] > 0 and l_comp["K2"] > 0, f"compacted launches "
          f"{l_comp}")
    launches["compact"] = l_comp
    it_ref = ref.iters.cpu().numpy()
    # the CLI route (the pipeline's mgcg settings) in float64: in float32
    # one image of the 256 stops above tol 1e-6 unsegmented too (1.05e-6,
    # the float32 floor of the pipeline's cycle on this medium), so the
    # comparison is made where both runs converge
    tables, t_cli, l_cli, subs_cli = {}, {}, {}, []
    lookup = dispatch._lookup

    def recording(name, batched):
        fn = lookup(name, batched=batched)

        def run(coeffs, spec, x, **kw):
            subs_cli.append(int(x.shape[0]))
            return fn(coeffs, spec, x, **kw)
        return run

    for comp in (0, 1):
        csv = WORK_DIR / f"batch_compact_{comp}.csv"
        csv.unlink(missing_ok=True)
        inp = WORK_DIR / f"input_compact_{comp}.txt"
        inp.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: {C4_BATCH}\n"
                       f"Ds: {CONTRAST}\nDf: 1\nSolver: mgcg\nCriterion: "
                       f"residual\nConvergence: {C4_KW['tol']}\n"
                       f"CheckEvery: 10\nMaxIter: {C4_KW['max_iter']}\n"
                       f"Dtype: float64\nCompact: {comp}\nOutputName: {csv}\n")
        zero_counts()
        dispatch._lookup = recording if comp else lookup
        try:
            tables[comp], t_cli[comp] = timed(lambda: batch.batch_sim(
                parse_input_file(str(inp)), imgs=list(imgs4), device=dev))
        finally:
            dispatch._lookup = lookup
        l_cli[comp] = counts()
    r_cli = np.abs(tables[1][:, 3] - tables[0][:, 3]) / np.abs(tables[0][:, 3])
    bad = np.flatnonzero(np.maximum(tables[0][:, 6], tables[1][:, 6])
                         > C4_KW["tol"])
    check(bad.size == 0 and l_cli[1]["K1"] > 0,
          f"the Compact: 1 CLI run: images {bad.tolist()} conv "
          f"{tables[1][bad, 6].tolist()} (unsegmented "
          f"{tables[0][bad, 6].tolist()}), launches {l_cli[1]}")
    check(bool(np.all(r_cli <= 1e-4)), f"Compact: 1 vs Compact: 0 Deff "
          f"rel err {r_cli.max()}")
    # the re-pack at full width: a later segment runs on fewer images
    check(len(subs_cli) > 1 and subs_cli[0] == C4_BATCH
          and min(subs_cli[1:]) < C4_BATCH,
          f"the Compact: 1 CLI run's sub-batches {subs_cli}")
    launches["compact CLI"] = l_cli[1]
    phase(37, t0, f"Compact: 1 {card}: config 4, {C4_BATCH} x {C4_SIZE}^2 "
          f"fp32: unsegmented {t_plain:.3f} s ({it_ref.min()}..."
          f"{it_ref.max()} iterations, launches {l_plain}); compacted "
          f"(segment {C4_SEGMENT}) {t_comp:.3f} s, {len(subs)} segments, "
          f"sub-batches {subs}, launches {l_comp}, max conv {conv.max():.3e}"
          f", Deff vs unsegmented max rel err {r_c.max():.3e}; the CLI "
          f"batch in f64 (the pipeline's mgcg settings): Compact: 0 "
          f"{t_cli[0]:.3f} s, launches {l_cli[0]}; Compact: 1 "
          f"{t_cli[1]:.3f} s, {len(subs_cli)} segments, sub-batches "
          f"{subs_cli}, launches {l_cli[1]}; max conv "
          f"{tables[1][:, 6].max():.3e}, Deff max rel err {r_cli.max():.3e}")
    del c4, s4, x04, ref, got, imgs4

    # -- 38: the sharded MGCG routes under run_pcg, config 3's generator.
    # In float32 at 2044x2048 every engine stops above relres 1e-4 at the
    # float32 floor (on an H100: route (a) 131 iterations at 5.9e-4, the
    # unsharded banded engine 96 at 1.1e-2, Deff 0.2142 and 0.4597 against
    # 0.2108 in float64), so the float32 leg is held to its plain version
    # only and the comparisons with the unsharded solve run in float64
    t0 = time.perf_counter()
    lines = []
    f64_kw = dict(C3_KW, tol=1e-5, max_iter=600)
    for label, shape, use_pallas, kw, dtype, vs_one in (
            ("(a) cycle-only, 511-row shards", SH_SHAPE, None, C3_KW,
             torch.float32, False),
            ("(a) cycle-only, 511-row shards", SH_SHAPE, None, f64_kw,
             torch.float64, True),
            ("(b) use_pallas=False, 511-row shards", SH_SHAPE, False,
             f64_kw, torch.float64, True),
            # a 24-row strip of config 3's medium does not percolate (at
            # 24x2048 on an H100 relres stayed above 27 over 400 iterations,
            # Deff ~0): this leg solves a log-uniform D of one decade, 96
            # wide so that the coarsest grid is solved; its rows coarsen to
            # 3 only below min_size 32
            ("(a) cycle-only, 6-row shards", SH_SMALL, None,
             dict(C3_KW, min_size=4, tol=1e-9), torch.float64, True)):
        if shape == SH_SMALL:
            d = np.exp(np.random.default_rng(C3_SEED).uniform(
                0.0, np.log(10.0), shape))
            dt = torch.tensor(d, dtype=dtype, device=dev)
            c = fvm.fvm_coefficients(dt, 0.0, 1.0)
            s = make_flux_spec(dt, 0.0, 1.0)
            x0 = (torch.arange(shape[1], dtype=dtype, device=dev)
                  / shape[1]).expand(shape)
        else:
            img = correlated_binary(np.random.default_rng(C3_SEED), *shape)
            _, c, s, x0 = c3_problem(img, dev, dtype)
        mesh = make_mesh(4, dp=1, sp=4, devices=[dev] * 4)
        zero_counts()
        res, secs = timed(lambda: halo.sharded_solve_mgcg(
            c, s, x0, mesh, use_pallas=use_pallas, **kw))
        l38 = counts()
        check(l38["K2"] > 0, f"route {label} launches {l38}")
        plain = halo.sharded_solve_mgcg(c, s, x0, mesh,
                                        use_pallas=use_pallas, plain=True,
                                        **kw)
        one = multigrid.solve_mgcg(c, s, x0, **kw)
        r_p, r_1 = rel(res.deff, plain.deff), rel(res.deff, one.deff)
        check(abs(int(res.iters) - int(plain.iters)) <= 2 and r_p <= 1e-6,
              f"route {label} vs plain: iterations {int(res.iters)} vs "
              f"{int(plain.iters)}, Deff rel err {r_p}")
        check(r_1 <= 1e-3 or not vs_one, f"route {label} vs the unsharded "
              f"solve: Deff {float(res.deff)} vs {float(one.deff)}")
        launches[f"{label} {str(dtype)[6:]}"] = l38
        lines.append(
            f"{label} {shape[0]}x{shape[1]} {str(dtype)[6:]} tol "
            f"{kw['tol']:.0e}: {int(res.iters)} iterations, relres "
            f"{float(res.conv):.3e}, Deff {float(res.deff):.6f}, "
            f"{secs:.3f} s, launches K2 {l38['K2']}, K8 {l38['K8 T1']}+"
            f"{l38['K8 T2']}; vs plain: iterations {int(plain.iters)}, Deff "
            f"rel err {r_p:.3e}; the unsharded solve_mgcg: "
            f"{int(one.iters)} iterations, relres {float(one.conv):.3e}, "
            f"Deff rel err {r_1:.3e}" + ("" if vs_one else " (not gated)"))
        del c, s, x0, res, plain, one
    phase(38, t0, f"sharded MGCG under run_pcg {card}: " + "; ".join(lines))

    # -- 39: the z-slab sharded 3D solvers on config 5's volume, SP=4 on
    # cuda:0; then the dry-run twin's 3D leg
    t0 = time.perf_counter()
    fluid5 = c5_fluid((C5_SIZE,) * 3, C5_SEED)
    mesh = make_mesh(4, dp=1, sp=4, devices=[dev] * 4)
    lines = []
    _, c5, s5, x05 = c5_problem(fluid5, dev)
    # float64 to relres 1e-6: at config 5's fp32 1e-4 the sharded run_pcg
    # solve and the fused engine stopped at the same 11 iterations 2.1e-4
    # apart in Deff on an H100 (two solves to 1e-4 by different paths),
    # and in fp32 the sharded solve ran 2000 iterations without reaching
    # 1e-5 (the fused engine: 214), as the JAX package's z-slab solve
    # stalls in float32 on a 128^3 copy (tests/solver_matrix_witness.py)
    mg5 = {k: C5_KW[k] for k in ("max_iter", "check_every", "criterion",
                                 "nu1", "nu2", "mg_omega", "coarse_iters",
                                 "min_size", "over")}
    mg5.update(tol=1e-6, max_iter=200)
    del c5, s5, x05
    _, c5, s5, x05 = c5_problem(fluid5, dev, torch.float64)
    zero_counts()
    res, secs = timed(lambda: halo3d.sharded_solve_mgcg_3d(c5, s5, x05,
                                                           mesh, **mg5))
    l39 = counts()
    check(l39["K6 whole"] > 0, f"halo3d mgcg launches {l39}")
    launches["halo3d mgcg"] = l39["K6 whole"]
    plain = halo3d.sharded_solve_mgcg_3d(c5, s5, x05, mesh, plain=True,
                                         **mg5)
    # the iterations are held against the solve on one slab (its levels
    # coarsen to the bottom, the SP=4 slabs stop at 2 planes) and against
    # another engine of the same algorithm: run_pcg unsharded with K6's
    # banded cycle on the full hierarchy (dmg3d with no coarse space, the
    # cycle in f64; its relres is taken on the equilibrated system, so it
    # may stop one check later).  The port's solve_mgcg_3d is the fused K7
    # engine, whose restarts and cadence differ (on an H100 it took 21
    # iterations where this one took 31): Deff only
    sp1 = halo3d.sharded_solve_mgcg_3d(
        c5, s5, x05, make_mesh(1, dp=1, sp=1, devices=[dev]), **mg5)
    unsharded = dmg3d.solve_dmg_3d(
        c5, s5, x05, defl=None, precond_f32=False, use_pallas="tiled3d",
        nu=mg5["nu1"], **{k: mg5[k] for k in (
            "tol", "max_iter", "check_every", "criterion", "mg_omega",
            "coarse_iters", "min_size", "over")})
    one = solvers3d.solve_mgcg_3d(c5, s5, x05, **dict(mg5, first_window=0))
    r_p, r_s, r_u, r_1 = (rel(res.deff, plain.deff), rel(res.deff, sp1.deff),
                          rel(res.deff, unsharded.deff),
                          rel(res.deff, one.deff))
    check(abs(int(res.iters) - int(plain.iters)) <= 2 and r_p <= 1e-6,
          f"halo3d mgcg vs plain: iterations {int(res.iters)} vs "
          f"{int(plain.iters)}, Deff rel err {r_p}")
    check(abs(int(res.iters) - int(sp1.iters)) <= 2 and r_s <= 1e-4,
          f"halo3d mgcg SP=4 vs SP=1: iterations {int(res.iters)} vs "
          f"{int(sp1.iters)}, Deff rel err {r_s}")
    check(abs(int(res.iters) - int(unsharded.iters)) <= mg5["check_every"]
          and r_u <= 1e-4, f"halo3d mgcg vs run_pcg unsharded on K6: "
          f"iterations {int(res.iters)} vs {int(unsharded.iters)}, Deff rel "
          f"err {r_u}")
    check(r_1 <= 1e-4, f"halo3d mgcg vs solve_mgcg_3d: Deff rel err {r_1}")
    lines.append(f"mgcg V(2,2) f64: {int(res.iters)} iterations, relres "
                 f"{float(res.conv):.3e}, Deff {float(res.deff):.6f}, "
                 f"{secs:.3f} s, {l39['K6 whole']} K6 whole launches; vs "
                 f"plain Deff rel err {r_p:.3e}; vs SP=1 ({int(sp1.iters)} "
                 f"iterations) {r_s:.3e}; vs run_pcg unsharded on K6 "
                 f"({int(unsharded.iters)} iterations) {r_u:.3e}; vs "
                 f"solve_mgcg_3d ({int(one.iters)} iterations) {r_1:.3e}")
    del res, plain, sp1, unsharded, one, c5, s5, x05
    _, c5, s5, x05 = c5_problem(fluid5, dev)
    jac = dict(omega=2.0 / 3.0, tol=1e-12, max_iter=H3D_JAC_CAP,
               check_every=100, criterion="residual")
    res, secs = timed(lambda: halo3d.sharded_solve_jacobi_3d(c5, s5, x05,
                                                             mesh, **jac))
    one = solvers3d.solve_jacobi_3d(c5, s5, x05, **jac)
    r_1 = rel(res.deff, one.deff)
    check(int(res.iters) == int(one.iters) and r_1 <= 1e-6,
          f"halo3d jacobi vs solve_jacobi_3d: {int(res.iters)} vs "
          f"{int(one.iters)} sweeps, Deff rel err {r_1}")
    lines.append(f"jacobi fp32, {int(res.iters)} sweeps: {secs:.3f} s, Deff "
                 f"rel err vs solve_jacobi_3d {r_1:.3e}")
    del c5, s5, x05, res, one
    # the CG leg in float64, so that the comparison sees the sharding and
    # not float32 rounding over 200 iterations
    _, c5, s5, x05 = c5_problem(fluid5, dev, torch.float64)
    cg = dict(tol=1e-12, max_iter=H3D_CG_CAP, check_every=100,
              criterion="relresidual")
    res, secs = timed(lambda: halo3d.sharded_solve_cg_3d(c5, s5, x05, mesh,
                                                         **cg))
    one = solvers3d.solve_cg_3d(c5, s5, x05, **cg)
    r_1 = rel(res.deff, one.deff)
    check(int(res.iters) == int(one.iters) and r_1 <= 1e-6,
          f"halo3d cg vs solve_cg_3d: {int(res.iters)} vs {int(one.iters)} "
          f"iterations, Deff rel err {r_1}")
    lines.append(f"cg f64, {int(res.iters)} iterations: {secs:.3f} s, Deff "
                 f"rel err vs solve_cg_3d {r_1:.3e}")
    del c5, s5, x05, res, one
    dry = dryrun_multichip([dev] * 4, out_dir=str(WORK_DIR))
    lines.append("dry-run twin: " + dry[1])
    phase(39, t0, f"halo3d {card}: {C5_SIZE}^3 at SP=4 on one card: "
          + "; ".join(lines))
    torch.cuda.empty_cache()

    # -- 40: native preprocessing
    t0 = time.perf_counter()
    check(_native.native_available(), "the native library did not build")
    img3 = correlated_binary(np.random.default_rng(C3_SEED), C3_SIZE,
                             C3_SIZE)
    imgs8 = bench_images(NATIVE_BATCH, NATIVE_SIZE)
    lines = []
    for label, stack in ((f"config 3's {C3_SIZE}^2", img3[None]),
                         (f"{NATIVE_BATCH} x {NATIVE_SIZE}^2", imgs8)):
        solid = stack > 150
        t1 = time.perf_counter()
        nat = [floodfill.flood_fill(m) for m in solid]
        t_nat = time.perf_counter() - t1
        t1 = time.perf_counter()
        sci = [floodfill.flood_fill(m, use_native=False) for m in solid]
        t_sci = time.perf_counter() - t1
        check(all(np.array_equal(a.participating, b.participating)
                  and np.array_equal(a.isolated, b.isolated)
                  and a.path_flag == b.path_flag
                  for a, b in zip(nat, sci)), f"{label}: native vs scipy")
        solid_d = torch.as_tensor(solid, device=dev)
        (part, iso, _), t_dev = timed(
            lambda: floodfill.participating_mask_device(solid_d))
        check(np.array_equal(part.cpu().numpy(),
                             np.stack([a.participating for a in nat]))
              and np.array_equal(iso.cpu().numpy(),
                                 np.stack([a.isolated for a in nat])),
              f"{label}: participating_mask_device vs flood_fill")
        lines.append(f"{label}: native {t_nat * 1e3:.1f} ms, scipy "
                     f"{t_sci * 1e3:.1f} ms, equal masks; "
                     f"participating_mask_device on the card "
                     f"{t_dev * 1e3:.1f} ms, equal")
    phase(40, t0, f"native preprocessing {card} ({_native._lib_path().name}): "
          + "; ".join(lines))
    return launches


# Phase 41: the differentiable Deff (ops/autodiff.py) on bench.py's images
# in float64 (K1/K2), a check every 500 iterations: at the default 10 the
# restart at every check stalls this medium's float64 solve near relres
# 1e-6 (PERF.md, PR 14), and V(2,2) as in the bench settings
AD_BATCH, AD_SIZE = 8, 512
AD_CYCLE = dict(min_size=8, coarse_iters=8, nu1=2, nu2=2, over=1.8,
                mg_omega=(1.281, 0.5584))
AD_KW = dict(tol=1e-10, max_iter=2000, check_every=500)
AD_FD_ITERS = 600                     # the finite differences' solves
AD_FIXED = 10                         # the fixed-budget leg against plain
AD_FD_CELLS = 4
# config 3's image in float32 on the banded engine (K4/K5) at relres 1e-6,
# phase 14's cycle and cadence; capped, since float32 may stall above 1e-6
AD32_CYCLE = dict(min_size=32, coarse_iters=64, nu1=2, nu2=2, over=1.8,
                  mg_omega=0.8)
AD32_KW = dict(tol=1e-6, max_iter=100, check_every=10)
# phase 42
CKPT_SEGMENT = 20
CKPT_KW = dict(tol=1e-8, check_every=10, first_window=10,
               criterion="residual", **AD_CYCLE)
PC_SIZE = 128                         # protocol carry: one bench image
PC_KW = dict(tol=1e-3, check_every=200, criterion="deff")
PC_SEGMENT = 3 * PC_KW["check_every"] + 1


def slice7_phases(dev, card, imgs, slice_s):
    """Phases 41-42: the differentiable Deff on K1/K2 and K4/K5, then the
    checkpoints, the profiling and debug helpers, the CMAP reader and the
    entry() twin on the card.  ``imgs``: phase 5's images; ``slice_s``: its
    best slice solve time."""
    import glob

    import torch

    from effectivediffusivityfvm_tpu_torch import entry as entry_mod
    from effectivediffusivityfvm_tpu_torch.config import SimulationConfig
    from effectivediffusivityfvm_tpu_torch.models import phases
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.autodiff import (
        deff_and_grad, make_differentiable_deff)
    from effectivediffusivityfvm_tpu_torch.ops.flux import make_flux_spec
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import cg_steps
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import \
        cg_steps_tiled
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import v_cycle
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_tiled import \
        v_cycle_tiled
    from effectivediffusivityfvm_tpu_torch.pipeline import single
    from effectivediffusivityfvm_tpu_torch.solvers import multigrid
    from effectivediffusivityfvm_tpu_torch.solvers.driver import SolveResult
    from effectivediffusivityfvm_tpu_torch.solvers.jacobi import solve_jacobi
    from effectivediffusivityfvm_tpu_torch.utils import checkpoint, debug
    from effectivediffusivityfvm_tpu_torch.utils.profiling import (
        benchmark_solver, trace)
    from effectivediffusivityfvm_tpu_torch.viz import read_cmap

    wrappers = {"K1": cg_steps, "K2": v_cycle, "K4": v_cycle_tiled,
                "K5": cg_steps_tiled}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts(names):
        return {k: wrappers[k].launches for k in names}

    def value_and_grad(f, d):
        """One forward and one backward pass of ``f`` at ``d``: (value,
        grad, forward s, backward s, launches of each pass)."""
        dd = d.clone().requires_grad_()
        torch.cuda.synchronize()
        zero_counts()
        t1 = time.perf_counter()
        val = f(dd)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fwd_n = counts(wrappers)
        zero_counts()
        (grad,) = torch.autograd.grad(val.sum(), dd)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return (val.detach(), grad, t2 - t1, t3 - t2, fwd_n,
                counts(wrappers))

    def timed_pair(f, d, names):
        """A warm-up, then the best of 3 forward and backward times; the
        main path's launch counts from the first timed run, each pass
        gated on every kernel in ``names``."""
        value_and_grad(f, d)
        runs = [value_and_grad(f, d) for _ in range(3)]
        val, grad, _, _, fwd_n, bwd_n = runs[0]
        for label, n in (("forward", fwd_n), ("backward", bwd_n)):
            for k in names:
                check(n[k] > 0, f"{k} not launched in the {label} pass: "
                      f"{n}")
        fwd = min(r[2] for r in runs)
        bwd = min(r[3] for r in runs)
        return val, grad, fwd, bwd, {k: fwd_n[k] for k in names}, \
            {k: bwd_n[k] for k in names}

    def iters_of(f):
        return {k: v.cpu().numpy() for k, v in f.iterations.items()}

    # -- 41: differentiable Deff, B=8 x 512^2 f64 on K1/K2
    t0 = time.perf_counter()
    classes = phases.two_phase_classes(imgs[:AD_BATCH])
    d = torch.tensor(phases.d_field_from_classes(classes, 1.0, CONTRAST),
                     dtype=torch.float64, device=dev)
    f = make_differentiable_deff(**AD_KW, solver_kw=AD_CYCLE)
    val, grad, fwd_s, bwd_s, fwd_n, bwd_n = timed_pair(f, d, ("K1", "K2"))
    its = iters_of(f)
    gmax = float(grad.abs().max())
    check(bool(torch.isfinite(grad).all()) and bool(torch.isfinite(val).all())
          and bool(((val > 0) & (val <= 1)).all()), "B=8 Deff/grad: "
          f"{val.tolist()}, grad finite {bool(torch.isfinite(grad).all())}")
    check(int(its["forward"].max()) < AD_KW["max_iter"]
          and int(its["adjoint"].max()) < AD_KW["max_iter"],
          f"B=8 solves at the cap: {its}")
    # the plain route, converged: its iterations and gradient differ as any
    # other order of the double sums makes them on this ill-conditioned
    # medium (a CPU run with K1's plain sums reversed: up to 5 of ~290
    # iterations and 5.3e-7 of max|g|), so the gates are the solve's own
    # sensitivity; then a fixed budget of AD_FIXED iterations (tol 0), where
    # the two routes must agree to rounding (that CPU run: 2.1e-11)
    legs = {}
    for leg, kw in (("converged", AD_KW),
                    ("fixed", dict(AD_KW, tol=0.0, max_iter=AD_FIXED))):
        runs = []
        for plain in (False, True):
            fr = make_differentiable_deff(**kw, solver_kw=dict(AD_CYCLE,
                                                               plain=plain))
            zero_counts()
            vr, gr, *_ = value_and_grad(fr, d)
            n = counts(("K1", "K2"))
            check(all((v == 0) if plain else (v > 0) for v in n.values()),
                  f"{leg} leg, plain {plain}: launches {n}")
            runs.append((vr, gr, iters_of(fr)))
        (vk, gk, itk), (vp, gp, itp) = runs
        legs[leg] = (itp, float(((vk - vp) / vp).abs().max()),
                     float((gk - gp).abs().max() / gk.abs().max()),
                     max(int(np.abs(itk[k].astype(int) - itp[k]).max())
                         for k in itk))
    its_p, v_err, g_err, d_it = legs["converged"]
    for k in its:
        check(bool(np.all(np.abs(its[k].astype(int) - its_p[k])
                          <= 0.1 * its_p[k] + 2)),
              f"{k} iterations {its[k].tolist()} vs plain "
              f"{its_p[k].tolist()}")
    check(v_err <= 1e-8 and g_err <= 1e-5, f"converged vs plain: Deff rel "
          f"err {v_err}, grad err {g_err} of max|g|")
    _, fv_err, fg_err, fd_it = legs["fixed"]
    check(fd_it == 0 and fv_err <= 1e-12 and fg_err <= 1e-9,
          f"{AD_FIXED} iterations vs plain: iterations differ by {fd_it}, "
          f"Deff rel err {fv_err}, grad err {fg_err} of max|g|")
    phase(41, t0, f"differentiable Deff {card}, B={AD_BATCH} x {AD_SIZE}^2 "
          f"f64 (relres {AD_KW['tol']:g}, a check every "
          f"{AD_KW['check_every']}): forward {fwd_s:.4f} s, backward "
          f"{bwd_s:.4f} s (ratio {bwd_s / fwd_s:.3f}), iterations forward "
          f"{its['forward'].tolist()}, adjoint {its['adjoint'].tolist()}, "
          f"launches forward {fwd_n}, backward {bwd_n}; vs plain converged: "
          f"iterations forward {its_p['forward'].tolist()}, adjoint "
          f"{its_p['adjoint'].tolist()} (max diff {d_it}), Deff rel err "
          f"{v_err:.3e}, grad err {g_err:.3e} of max|g| {gmax:.3e}; "
          f"{AD_FIXED} iterations: Deff rel err {fv_err:.3e}, grad err "
          f"{fg_err:.3e} of max|g|")

    # central differences on image 0's fluid cells of the largest |grad|.
    # The gradient and the differences come from one callable that runs
    # AD_FD_ITERS iterations (tol 0: past the float64 floor), so both
    # solves of a difference take the same steps: solved to a tolerance
    # instead, their errors (~1e-13 of Deff at relres 1e-13) differ by
    # ~1e-5 of these cells' differences
    t0 = time.perf_counter()
    d0 = d[0].clone().requires_grad_()
    ff = make_differentiable_deff(
        **dict(AD_KW, tol=0.0, max_iter=AD_FD_ITERS), solver_kw=AD_CYCLE)
    (g0,) = torch.autograd.grad(ff(d0), d0)
    d0 = d0.detach()
    g0_dist = float((grad[0] - g0).abs().max() / g0.abs().max())
    fluid = torch.where(d0 == 1.0, g0.abs(), torch.zeros_like(g0))
    fd_err, fd_lines = 0.0, []
    for c in torch.topk(fluid.flatten(), AD_FD_CELLS).indices.tolist():
        i, j = divmod(c, AD_SIZE)
        eps = 1e-5 * float(d0[i, j])
        fvals = []
        for sgn in (1.0, -1.0):
            dpm = d0.clone()
            dpm[i, j] += sgn * eps
            fvals.append(float(ff(dpm)))
        fd = (fvals[0] - fvals[1]) / (2 * eps)
        an = float(g0[i, j])
        rel = abs(fd - an) / max(abs(fd), abs(an))
        check(rel <= 1e-5, f"finite difference at {(i, j)}: {fd} vs {an}")
        fd_err = max(fd_err, rel)
        fd_lines.append(f"{(i, j)} {an:.6e}")
    u = torch.full((AD_SIZE, AD_SIZE), 2.5, dtype=torch.float64, device=dev)
    uv, ug = deff_and_grad(u, **AD_KW, solver_kw=AD_CYCLE)
    u_err = abs(float(uv) - 2.5) / 2.5
    u_sum = float(ug.sum())
    check(u_err <= 1e-9, f"uniform medium Deff {float(uv)}")
    check(abs(u_sum - 1.0) <= 1e-6, f"uniform medium sum grad {u_sum}")
    phase(41, t0, f"central differences (eps 1e-5 d, solves of "
          f"{AD_FD_ITERS} iterations) on image 0 at {', '.join(fd_lines)}: "
          f"max rel err {fd_err:.3e} (the batch gradient at relres "
          f"{AD_KW['tol']:g} is {g0_dist:.3e} of max|g| off image 0's); "
          f"uniform "
          f"{AD_SIZE}^2 d=2.5: Deff rel err {u_err:.3e}, sum grad - 1 "
          f"{u_sum - 1:.3e}")
    del d, grad, g0, f, ff, u, ug

    # config 3's 2048^2 image in float32 (K4/K5), against its plain route
    # and, ungated, the float64 gradient (K1/K2)
    t0 = time.perf_counter()
    rng = np.random.default_rng(C3_SEED)
    d3 = c3_problem(correlated_binary(rng, C3_SIZE, C3_SIZE), dev)[0]
    f32 = make_differentiable_deff(**AD32_KW, solver_kw=AD32_CYCLE)
    val32, g32, fwd32, bwd32, fwd32_n, bwd32_n = timed_pair(
        f32, d3, ("K4", "K5"))
    its32 = iters_of(f32)
    fp32 = make_differentiable_deff(**AD32_KW, solver_kw=dict(AD32_CYCLE,
                                                              plain=True))
    zero_counts()
    vp32, gp32, *_ = value_and_grad(fp32, d3)
    check(counts(("K4", "K5")) == {"K4": 0, "K5": 0},
          f"the plain route launched {counts(('K4', 'K5'))}")
    its32_p = iters_of(fp32)
    g32max = float(g32.abs().max())
    g32_err = float((g32 - gp32).abs().max())
    for k in ("forward", "adjoint"):
        check(abs(int(its32[k]) - int(its32_p[k])) <= 2,
              f"fp32 {k} iterations {its32[k]} vs plain {its32_p[k]}")
    check(bool(torch.isfinite(g32).all()), "fp32 gradient not finite")
    check(g32_err <= 1e-5 * g32max, f"fp32 grad vs plain {g32_err} > "
          f"1e-5 * {g32max}")
    f64 = make_differentiable_deff(**AD_KW, solver_kw=AD32_CYCLE)
    zero_counts()
    v64, g64, fwd64, bwd64, *_ = value_and_grad(f64, d3.double())
    its64 = iters_of(f64)
    check(counts(("K1", "K2"))["K1"] > 0, "f64 2048^2 launched no K1")
    g_dist = float((g32.double() - g64).abs().max() / g64.abs().max())
    phase(41, t0, f"config 3 {C3_SIZE}^2 fp32 (relres {AD32_KW['tol']:g}, "
          f"cap {AD32_KW['max_iter']}) {card}: forward {fwd32:.4f} s, "
          f"backward {bwd32:.4f} s (ratio {bwd32 / fwd32:.3f}), iterations "
          f"forward {its32['forward']}, adjoint {its32['adjoint']} (plain "
          f"{its32_p['forward']}, {its32_p['adjoint']}), launches forward "
          f"{fwd32_n}, backward {bwd32_n}; grad vs plain max abs err "
          f"{g32_err:.3e} (max|g| {g32max:.3e}); Deff {float(val32):.6f} vs "
          f"f64 {float(v64):.6f}; f64 on K1/K2: {its64['forward']}, "
          f"{its64['adjoint']} iterations, forward {fwd64:.4f} s, backward "
          f"{bwd64:.4f} s; fp32 grad vs f64 max|diff|/max|g64| {g_dist:.3e} "
          f"(not gated)")
    del d3, g32, gp32, g64, f32, fp32, f64
    torch.cuda.empty_cache()

    # -- 42: the other modules on the card
    t0 = time.perf_counter()
    lines = []
    d1 = torch.tensor(phases.d_field_from_classes(classes[:1], 1.0,
                                                  CONTRAST)[0],
                      dtype=torch.float64, device=dev)
    c1, s1 = fvm.fvm_coefficients(d1, 0.0, 1.0), make_flux_spec(d1, 0.0, 1.0)
    x1 = (torch.arange(AD_SIZE, dtype=torch.float64, device=dev)
          / AD_SIZE).expand(AD_SIZE, AD_SIZE)
    ck = WORK_DIR / "ckpt42.npz"
    ck.unlink(missing_ok=True)
    zero_counts()
    seg = checkpoint.checkpointed_solve(
        multigrid.solve_mgcg, c1, s1, x1, checkpoint_path=str(ck),
        segment_iters=CKPT_SEGMENT, max_iter=2000, **CKPT_KW)
    seg_n = counts(("K1", "K2"))
    check(seg_n["K1"] > 0 and seg_n["K2"] > 0, f"checkpointed solve {seg_n}")
    ref = multigrid.solve_mgcg(c1, s1, x1, max_iter=2000, **CKPT_KW)
    ck_rel = abs(float(seg.deff) - float(ref.deff)) / float(ref.deff)
    check(float(seg.conv) <= CKPT_KW["tol"], f"segmented conv {seg.conv}")
    check(ck_rel <= 1e-6, f"segmented Deff rel err {ck_rel}")
    zero_counts()
    t1 = time.perf_counter()
    again = checkpoint.checkpointed_solve(
        multigrid.solve_mgcg, c1, s1, x1, checkpoint_path=str(ck),
        segment_iters=CKPT_SEGMENT, max_iter=2000, **CKPT_KW)
    resume_s = time.perf_counter() - t1
    check(counts(("K1",))["K1"] == 0 and int(again.iters) == int(seg.iters)
          and float(again.deff) == float(seg.deff)
          and again.x.device == x1.device, "the resumed call solved again")
    lines.append(f"checkpointed mgcg {AD_SIZE}^2 f64, segments of "
                 f"{CKPT_SEGMENT}: {int(seg.iters)} iterations (unsegmented "
                 f"{int(ref.iters)}), Deff rel err {ck_rel:.3e}, launches "
                 f"{seg_n}; resumed from the file in {resume_s * 1e3:.1f} ms")

    img_pc = bench_images(1, PC_SIZE)[0]
    dpc = torch.tensor(phases.d_field_from_classes(
        phases.two_phase_classes(img_pc), 1.0, CONTRAST), dtype=torch.float64,
        device=dev)
    cpc, spc = fvm.fvm_coefficients(dpc, 0.0, 1.0), make_flux_spec(dpc, 0.0,
                                                                  1.0)
    xpc = (torch.arange(PC_SIZE, dtype=torch.float64, device=dev)
           / PC_SIZE).expand(PC_SIZE, PC_SIZE)
    t1 = time.perf_counter()
    cont = solve_jacobi(cpc, spc, xpc, max_iter=500_000, **PC_KW)
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t1
    pc = WORK_DIR / "carry42.npz"
    pc.unlink(missing_ok=True)
    t1 = time.perf_counter()
    carried = checkpoint.checkpointed_solve(
        solve_jacobi, cpc, spc, xpc, checkpoint_path=str(pc),
        segment_iters=PC_SEGMENT, max_iter=500_000, protocol_carry=True,
        **PC_KW)
    torch.cuda.synchronize()
    carry_s = time.perf_counter() - t1
    check(int(carried.iters) == int(cont.iters) < 500_000,
          f"protocol carry stopped at {int(carried.iters)}, the continuous "
          f"run at {int(cont.iters)}")
    check(float(carried.deff) == float(cont.deff)
          and bool(torch.equal(carried.x, cont.x)),
          f"protocol carry Deff {float(carried.deff)} vs {float(cont.deff)}")
    lines.append(f"protocol carry, jacobi {PC_SIZE}^2 f64 (deff "
                 f"{PC_KW['tol']:g}, a check every {PC_KW['check_every']}, "
                 f"segments of {PC_SEGMENT}): {int(carried.iters)} sweeps "
                 f"as the continuous run, Deff {float(cont.deff):.6f} and "
                 f"the field equal, {carry_s:.2f} s vs {cont_s:.2f} s")

    saved = [WORK_DIR / f"async42_{i}.npz" for i in range(2)]
    with checkpoint.AsyncSaver() as saver:
        for i, p in enumerate(saved):
            saver.save(str(p), seg.x + i, iters=i,
                       meta={"deff": seg.deff})
    for i, p in enumerate(saved):
        xs, it, meta = checkpoint.load_state(str(p))
        check(np.array_equal(xs, (seg.x + i).cpu().numpy()) and it == i
              and float(meta["deff"]) == float(seg.deff),
              f"AsyncSaver file {p.name}")
    lines.append("AsyncSaver round trip of the CUDA field equal")

    coeffs, spec, x0 = build_problem(imgs, dev)
    log_dir = WORK_DIR / "trace42"
    for old in glob.glob(str(log_dir / "*")):
        Path(old).unlink()
    with trace(str(log_dir)):
        multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW)
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    check(len(files) == 1, f"trace files {files}")
    names = {e.get("name", "") for e in json.load(open(files[0]))
             .get("traceEvents", [])}
    k1_seen = sorted({n for n in names if any(
        k in n for k in ("pass_p_kernel", "pass_x_kernel", "pass_z_kernel"))})
    k2_seen = sorted({n for n in names if any(k in n for k in K2_KERNELS)})
    check(k1_seen and k2_seen, f"the trace names no K1 ({k1_seen}) or K2 "
          f"({k2_seen}) kernel")
    lines.append(f"trace of a slice solve: {Path(files[0]).stat().st_size} "
                 f"bytes, {len(k1_seen)} K1 and {len(k2_seen)} K2 kernel "
                 f"names")
    bench = benchmark_solver(multigrid.solve_mgcg_batched, coeffs, spec, x0,
                             **SOLVE_KW)
    lines.append(f"benchmark_solver: best {bench['seconds']:.4f} s "
                 f"({BATCH / bench['seconds']:.1f} solves/s, times "
                 f"{', '.join(f'{t:.4f}' for t in bench['times'])}, "
                 f"{bench['iterations']} iterations) beside phase 5's "
                 f"{slice_s:.4f} s")
    del coeffs, spec, x0

    nan_res = SolveResult(x=torch.full((4, 4), float("nan"), device=dev),
                          deff=torch.tensor(0.5, device=dev),
                          conv=torch.tensor(0.0, device=dev),
                          iters=torch.tensor(1, device=dev))
    try:
        debug.nan_guard(lambda: nan_res, "nan-solve")()
    except FloatingPointError as e:
        nan_msg = str(e)
    else:
        raise RuntimeError("check failed: nan_guard let a CUDA NaN through")
    debug.check_finite(seg, "checkpointed solve")
    lines.append(f"nan_guard: {nan_msg}")

    cmap = WORK_DIR / "cmap42.csv"
    cfg = SimulationConfig(solver="mgcg", d_solid=CONTRAST, dtype="float64",
                           criterion="residual", convergence=1e-8,
                           max_iter=2000, print_cmap=True,
                           cmap_name=str(cmap),
                           output_name=str(WORK_DIR / "single42.csv"))
    res = single.single_sim(cfg, img=img_pc, device="cuda")
    back = read_cmap(str(cmap))
    check(back.shape == res.x.shape, f"read_cmap shape {back.shape}")
    cmap_err = np.max(np.abs(back - res.x) / np.maximum(np.abs(res.x),
                                                        1e-300))
    check(cmap_err <= 1e-3, f"read_cmap vs the field: rel err {cmap_err}")
    lines.append(f"read_cmap of single_sim's {PC_SIZE}^2 CMAP equal to the "
                 f"field to its printed digits (max rel err "
                 f"{cmap_err:.1e})")

    fwd_e, args_e = entry_mod.entry()
    deff_card = fwd_e(*args_e).cpu().numpy()
    fwd_c, args_c = entry_mod.entry(device="cpu")
    deff_cpu = fwd_c(*args_c).numpy()
    e_rel = float(np.max(np.abs(deff_card - deff_cpu) / np.abs(deff_cpu)))
    check(np.all(np.isfinite(deff_card)) and e_rel <= 1e-5,
          f"entry() on the card {deff_card} vs the CPU {deff_cpu}")
    lines.append(f"entry(): Deff {np.round(deff_card, 6).tolist()}, rel err "
                 f"to the CPU {e_rel:.3e}")
    phase(42, t0, f"{card}: " + "; ".join(lines))


# phases 43-45: the general-cycle engines.  On config 3 the run_pcg form
# stalls above relres 1e-4 in float32 (on an NVIDIA H100 80GB HBM3 at
# 700 W: K2 5.8e-4 and K4 1.7e-4 after 400 iterations, the plain cycle
# 1.5e-4 after 251), so its float32 legs run to a cap and are held to
# their plain versions.  In float64 no engine reaches relres 1e-8 in 400
# iterations there (a restart every 10: fused 1.2e-6, plain V(2,2) 1.7e-6,
# V(2,1) 4.4e-7; every 100: 1.6e-7, 3.4e-8 and, the V(2,1) cycle not
# being symmetric, 7.2e-5), so the float64 legs run to a cap with a
# restart every 10: the plain V(2,2) engine follows the fused engine's
# iterates (Deff 1.8e-12 apart at 400), V(2,1) is held as the sharded
# float64 solves are.  On config 5 two solves that each stop at relres
# 1e-4 differ by up to 1.5e-3 in Deff (the fused engine at 4.6e-5 and at
# 2.1e-5: 1.4e-3), so phase 44 holds the plain 3D cycle to 5e-3
GC_CAP = 100                          # phase 43's float32 legs
GC64_KW = dict(C3_KW, tol=1e-8, max_iter=150)      # phase 43's float64 legs
GC5_CAP = 60                          # phase 44: config 5 on the plain cycle
GC_SH_KW = dict(C3_KW, tol=1e-5, max_iter=600, nu2=1)   # phase 44 sharded
GC_DMG_CAP, GC_DMG3D_CAP = 100, 40    # phase 44: the dmg legs' caps
# Deff gates against another engine at the same cap, each set above its
# reading (NVIDIA H100 80GB HBM3, 700 W) and below what a wrong cycle
# would give: auto V(2,1) against the fused V(2,2) after 150 iterations
# (3.1e-5), dmg's plain cycle against its K4 cycle after 100 (3.0e-5)
GC_V21_RTOL = GC_DMG_RTOL = 1e-4
# dmg3d on phase 36's volume after 40 iterations (that card): the plain
# cycle at nu = 3 has K6's relres (5.0461e-4 both) and Deff (1e-8 apart),
# so it is held to K6 at 1e-6; nu = 4 reaches 4.5996e-4, 0.91 of nu = 3's
# (nu = 2: 9.6514e-4, 1.9 of it), and is held to 1.2 of it
GC_DMG3D_RTOL, GC_DMG3D_NU4 = 1e-6, 1.2


def general_cycle_phases(dev, card, imgs64, inp10_text, table10):
    """Phases 43-45: the engines under ``run_pcg`` that take any cycle --
    the cycle-only PCG on K2 (``use_pallas=True``) and on K4
    (``"tiledcycle"``), the plain torch cycle (``False``, and auto for
    V(2,1)) -- on config 3, then the plain cycle on config 5, config 3 at
    SP=4, the ``dmg`` legs, and the CLI batch with ``Pallas: off`` and
    ``interpret``.  ``imgs64``, ``inp10_text``, ``table10``: phase 10's
    images, input and table."""
    import torch

    from effectivediffusivityfvm_tpu_torch.config import parse_input_file
    from effectivediffusivityfvm_tpu_torch.models import phases, volume
    from effectivediffusivityfvm_tpu_torch.ops import fvm3d
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import cg_steps
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep_tiled import \
        cg_steps_tiled
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import v_cycle
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle3d import \
        v_cycle3d
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle_tiled import \
        v_cycle_tiled
    from effectivediffusivityfvm_tpu_torch.parallel import halo
    from effectivediffusivityfvm_tpu_torch.parallel.mesh import make_mesh
    from effectivediffusivityfvm_tpu_torch.pipeline import batch
    from effectivediffusivityfvm_tpu_torch.solvers import (dispatch, dmg,
                                                           dmg3d, multigrid,
                                                           solvers3d)

    wrappers = {"K1": cg_steps, "K2": v_cycle, "K4": v_cycle_tiled,
                "K5": cg_steps_tiled, "K6": v_cycle3d}

    def run(fn):
        """``fn()`` with the launch counts set to 0 just before and read just
        after: (result, seconds, launches)."""
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        return out, secs, {k: w.launches for k, w in wrappers.items()}

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    def text(res, secs, l=None):
        out = (f"{int(res.iters)} iterations, relres {float(res.conv):.3e}, "
               f"Deff {float(res.deff):.6f}, {secs:.3f} s")
        if l is not None:
            out += f", launches K2 {l['K2']} K4 {l['K4']}"
        return out

    # -- 43: config 3's image on the run_pcg engines
    t0 = time.perf_counter()
    img3 = correlated_binary(np.random.default_rng(C3_SEED), C3_SIZE,
                             C3_SIZE)
    _, c32, s32, x32 = c3_problem(img3, dev)
    lines = []
    for engine, key in ((True, "K2"), ("tiledcycle", "K4")):
        kw = dict(C3_KW, use_pallas=engine, max_iter=GC_CAP)
        multigrid.solve_mgcg(c32, s32, x32, **kw)                # warm-up
        res, secs, l = run(lambda: multigrid.solve_mgcg(c32, s32, x32, **kw))
        others = sum(v for k, v in l.items() if k != key)
        check(l[key] > 0 and others == 0,
              f"use_pallas={engine!r} launches {l}")
        plain, p_secs, _ = run(lambda: multigrid.solve_mgcg(
            c32, s32, x32, plain=True, **kw))
        d_it, r_p = abs(int(res.iters) - int(plain.iters)), rel(res.deff,
                                                                plain.deff)
        check(np.isfinite(float(res.deff)) and d_it <= 2 and r_p <= 1e-6,
              f"use_pallas={engine!r}: Deff {float(res.deff)}, iterations "
              f"{int(res.iters)} vs plain {int(plain.iters)}, Deff rel err "
              f"{r_p}")
        lines.append(f"use_pallas={engine!r} ({key}) fp32 V(2,2), cap "
                     f"{GC_CAP}: {text(res, secs, l)}; plain "
                     f"{int(plain.iters)} iterations, {p_secs:.3f} s, Deff "
                     f"rel err {r_p:.3e}")
    res, secs, l = run(lambda: multigrid.solve_mgcg(
        c32, s32, x32, use_pallas=False, **dict(C3_KW, max_iter=GC_CAP)))
    check(sum(l.values()) == 0 and np.isfinite(float(res.deff)),
          f"use_pallas=False fp32: launches {l}, Deff {float(res.deff)}")
    lines.append(f"use_pallas=False fp32 V(2,2), cap {GC_CAP}: "
                 f"{text(res, secs)}" + ("" if float(res.conv) <= C3_KW["tol"]
                                         else " (relres 1e-4 not reached; "
                                         "not gated)"))
    del c32, s32, x32, res, plain
    _, c64, s64, x64 = c3_problem(img3, dev, torch.float64)
    fused, f_secs, _ = run(lambda: multigrid.solve_mgcg(
        c64, s64, x64, use_pallas="cgstep", **GC64_KW))
    lines.append(f"fused \"cgstep\" f64 V(2,2) to {GC64_KW['tol']:.0e} "
                 f"(cap {GC64_KW['max_iter']}): {text(fused, f_secs)}")
    check(multigrid._engine_auto(C3_SIZE, C3_SIZE, torch.float64, 2, 1)
          is False, "auto does not take the plain engine for V(2,1)")
    for label, kw, gate in (("use_pallas=False f64 V(2,2)",
                             dict(GC64_KW, use_pallas=False), 1e-6),
                            ("auto f64 V(2,1)", dict(GC64_KW, nu2=1),
                             GC_V21_RTOL)):
        res, secs, l = run(lambda: multigrid.solve_mgcg(c64, s64, x64, **kw))
        r_f = rel(res.deff, fused.deff)
        check(sum(l.values()) == 0 and r_f <= gate,
              f"{label}: launches {l}, relres {float(res.conv)}, Deff "
              f"{float(res.deff)} vs the fused f64 {float(fused.deff)}")
        lines.append(f"{label}: {text(res, secs)}, Deff rel err to the "
                     f"fused f64 {r_f:.3e}")
    phase(43, t0, f"config 3 on the run_pcg engines {card}: "
          + "; ".join(lines))

    # -- 44: config 5 on the plain cycle, config 3 at SP=4 with V(2,1), dmg
    t0 = time.perf_counter()
    lines = []
    _, c5, s5, x05 = c5_problem(c5_fluid((C5_SIZE,) * 3, C5_SEED), dev)
    ref5, r5_secs, _ = run(lambda: solvers3d.solve_mgcg_3d(c5, s5, x05,
                                                           **C5_KW))
    lines.append(f"config 5 fused (phase 21's): {text(ref5, r5_secs)}")
    check(solvers3d._engine_auto_3d(2, 1) is False,
          "auto does not take the plain 3D engine for V(2,1)")
    for label, kw in (("use_pallas=False V(2,2)",
                       dict(use_pallas=False)), ("auto V(2,1)", dict(nu2=1))):
        res, secs, l = run(lambda: solvers3d.solve_mgcg_3d(
            c5, s5, x05, **dict(C5_KW, max_iter=GC5_CAP, **kw)))
        reached = float(res.conv) <= C5_KW["tol"]
        r_5 = rel(res.deff, ref5.deff)
        check(np.isfinite(float(res.deff)) and (not reached or r_5 <= 5e-3),
              f"config 5 {label}: relres {float(res.conv)}, Deff "
              f"{float(res.deff)} vs {float(ref5.deff)}")
        lines.append(f"config 5 {label}: {text(res, secs)}, Deff rel err "
                     f"{r_5:.3e}" + ("" if reached else
                                     f" (the cap {GC5_CAP}; not gated)"))
    del c5, s5, x05, ref5
    mesh4 = make_mesh(4, dp=1, sp=4, devices=[dev] * 4)
    res, secs, l = run(lambda: halo.sharded_solve_mgcg(c64, s64, x64, mesh4,
                                                       **GC_SH_KW))
    one, o_secs, _ = run(lambda: multigrid.solve_mgcg(c64, s64, x64,
                                                      **GC_SH_KW))
    r_1 = rel(res.deff, one.deff)
    d_1 = abs(int(res.iters) - int(one.iters))
    check(float(res.conv) <= GC_SH_KW["tol"] and r_1 <= 1e-3 and d_1 <= 2
          and l["K2"] == 0, f"config 3 SP=4 V(2,1): relres "
          f"{float(res.conv)}, iterations {int(res.iters)} vs "
          f"{int(one.iters)}, Deff rel err to the unsharded solve {r_1}, "
          f"launches {l}")
    lines.append(f"config 3 f64 SP=4 V(2,1) (run_pcg, the plain tail): "
                 f"{text(res, secs, l)}; unsharded {text(one, o_secs)}, "
                 f"Deff rel err {r_1:.3e}")
    kw = dict(DMG3_KW, max_iter=GC_DMG_CAP)
    res, secs, l = run(lambda: dmg.solve_dmg(c64, s64, x64, use_pallas=False,
                                             **kw))
    k4, k_secs, _ = run(lambda: dmg.solve_dmg(c64, s64, x64, **kw))
    r_k4 = rel(res.deff, k4.deff)
    check(sum(l.values()) == 0 and float(res.conv) <= 1e-2
          and r_k4 <= GC_DMG_RTOL, f"dmg use_pallas=False: launches {l}, "
          f"relres {float(res.conv)}, Deff {float(res.deff)} vs "
          f"{float(k4.deff)} on K4")
    lines.append(f"config 3 dmg f64 use_pallas=False (cap {GC_DMG_CAP}): "
                 f"{text(res, secs)}; on K4 {text(k4, k_secs)}, Deff rel "
                 f"gap {r_k4:.3e}")
    del c64, s64, x64, res, one, k4
    n = DMG3D_SIZE
    vol = gas_volume(c5_fluid((n,) * 3, C5_SEED), C5_SEED)
    classes = phases.three_phase_classes(vol)
    mask = (vol > 200) | volume.flood_fill_3d(vol > 200).isolated
    gas = (classes == phases.GAS) & ~mask
    d = torch.tensor(phases.d_field_from_classes(
        classes, 1.0, 0.0, DMG3D_DG, dtype=np.float64), device=dev)
    c = fvm3d.fvm_coefficients_3d(d, 0.0, 1.0, mask=torch.as_tensor(
        mask, device=dev), symmetric=True)
    s = fvm3d.make_flux_spec_3d(d, 0.0, 1.0)
    x0 = (torch.arange(n, dtype=torch.float64, device=dev) / n).expand(
        (n,) * 3)
    defl = dmg3d.build_component_deflation_3d(c, gas)
    check(dmg3d._dmg3d_engine_auto((n,) * 3, torch.float32, 4) is False,
          "dmg3d auto does not take the plain cycle at nu=4")
    kw = dict(DMG3D_KW, max_iter=GC_DMG3D_CAP, defl=defl)
    # the plain cycle held to K6's at nu = 3, then run at nu = 4, past K6's
    k6, k_secs, l = run(lambda: dmg3d.solve_dmg_3d(c, s, x0, nu=3, **kw))
    check(l["K6"] > 0, f"dmg3d nu=3 on K6: launches {l}")
    res, secs, l = run(lambda: dmg3d.solve_dmg_3d(c, s, x0, nu=3,
                                                  use_pallas=False, **kw))
    r_6 = rel(res.deff, k6.deff)
    c_6 = rel(res.conv, k6.conv)
    check(l["K6"] == 0 and r_6 <= GC_DMG3D_RTOL and c_6 <= GC_DMG3D_RTOL,
          f"dmg3d nu=3 plain cycle vs K6: launches {l}, Deff rel err "
          f"{r_6}, relres {float(res.conv)} vs {float(k6.conv)}")
    lines.append(f"{n}^3 3-phase dmg3d f64 nu=3 (cap {GC_DMG3D_CAP}) on "
                 f"K6: {text(k6, k_secs)}; on the plain cycle "
                 f"{text(res, secs)}, Deff rel err {r_6:.3e}, relres rel "
                 f"err {c_6:.3e}")
    res, secs, l = run(lambda: dmg3d.solve_dmg_3d(c, s, x0, nu=4, **kw))
    check(l["K6"] == 0 and np.isfinite(float(res.deff))
          and float(res.conv) <= GC_DMG3D_NU4 * float(k6.conv),
          f"dmg3d nu=4: launches {l}, relres {float(res.conv)} vs "
          f"{float(k6.conv)} at nu=3")
    lines.append(f"dmg3d nu=4 (the plain cycle, cap {GC_DMG3D_CAP}): "
                 f"{text(res, secs)}, relres / nu=3's "
                 f"{float(res.conv) / float(k6.conv):.3f}")
    del c, s, d, x0, defl, res, k6
    phase(44, t0, f"3D, sharded and dmg on the plain cycle {card}: "
          + "; ".join(lines))

    # -- 45: phase 10's mgcg CLI batch with Pallas: off and interpret
    t0 = time.perf_counter()
    lines = []
    for mode in ("off", "interpret"):
        csv = WORK_DIR / f"batch_mgcg_{mode}.csv"
        csv.unlink(missing_ok=True)
        inp = WORK_DIR / f"input_mgcg_{mode}.txt"
        inp.write_text(re.sub(r"OutputName: .*", f"OutputName: {csv}",
                              inp10_text) + f"Pallas: {mode}\n")
        cfg = parse_input_file(str(inp))
        table, secs, l = run(lambda: batch.batch_sim(cfg, imgs=list(imgs64),
                                                     device="cuda"))
        r10 = np.abs(table[:, 3] - table10[:, 3]) / np.abs(table10[:, 3])
        check(sum(l.values()) == 0 and bool(np.all(table[:, 6] <= 1e-6)),
              f"Pallas: {mode}: launches {l}, max conv {table[:, 6].max()}")
        line = (f"Pallas: {mode}: max conv {table[:, 6].max():.3e}, "
                f"{secs:.3f} s, Deff vs phase 10 max rel err {r10.max():.3e}"
                f" (median {np.median(r10):.3e})")
        if mode == "interpret":
            check(bool(np.all(r10 <= 1e-4)), f"Pallas: interpret Deff vs "
                  f"phase 10 rel err {r10.max()}")
        else:
            # the CLI route must compute what the plain engine computes with
            # the pipeline's settings; against phase 10 (the fused engine,
            # which stops at another iterate) only a sanity bound, as phase
            # 10 holds against phase 5
            c, s, xk = build_problem(imgs64, dev)
            direct = dispatch.solve_batched(
                "mgcg", c, s, xk, omega=cfg.omega, tol=cfg.convergence,
                max_iter=cfg.max_iter, check_every=cfg.check_every,
                criterion=cfg.criterion, first_window=cfg.first_window,
                use_pallas=False)
            d_direct = direct.deff.cpu().numpy().astype(np.float64)
            r_d = np.abs(table[:, 3] - d_direct) / d_direct
            check(bool(np.all(r_d <= 1e-6) and np.all(r10 <= 0.1)),
                  f"Pallas: off Deff vs the direct solve {r_d.max()}, vs "
                  f"phase 10 {r10.max()}")
            line += f", vs the direct use_pallas=False solve {r_d.max():.3e}"
            del c, s, xk, direct
        lines.append(line)
    phase(45, t0, f"CLI batch mgcg, 64 x {SIZE}^2 {card}: "
          + "; ".join(lines))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from effectivediffusivityfvm_tpu_torch.config import (SimulationConfig,
                                                          parse_input_file)
    from effectivediffusivityfvm_tpu_torch.io import images as img_io
    from effectivediffusivityfvm_tpu_torch.ops import fvm
    from effectivediffusivityfvm_tpu_torch.ops.kernels import _build
    from effectivediffusivityfvm_tpu_torch.ops.kernels.cgstep import (
        batch_sum, cg_steps, cg_steps_reference)
    from effectivediffusivityfvm_tpu_torch.ops.kernels import jacobi as k3mod
    from effectivediffusivityfvm_tpu_torch.ops.kernels.jacobi import (
        jacobi_resident_fits, jacobi_sweeps, jacobi_sweeps_reference)
    from effectivediffusivityfvm_tpu_torch.ops.kernels.vcycle import (
        cycle_launches, cycle_resident_from, v_cycle, v_cycle_reference)
    from effectivediffusivityfvm_tpu_torch.pipeline import batch, single
    from effectivediffusivityfvm_tpu_torch.solvers import (dispatch, driver,
                                                           jacobi_pallas,
                                                           multigrid)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    card = f"[{smi}]"
    t_all = time.perf_counter()
    print(f"phase 1 device: {name}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    # -- 2: build
    t0 = time.perf_counter()
    info = _build.build_info()
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", info["log"])]
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", info["log"])]
    phase(2, t0, f"build: {info['seconds']:.1f} s, {len(regs)} kernels, "
          f"registers {min(regs, default=0)}..{max(regs, default=0)}, "
          f"spill bytes {sum(spills)}")
    lib = _build.load_library()

    # -- 3: K2 against its plain version, bit for bit: B=8 x 512^2 in fp32
    # and fp64 with images 2 and 5 gated, and config 3's K2 tail (levels 1..
    # of the banded 2048^2 hierarchy, B=1), each in the rule's launches
    t0 = time.perf_counter()
    imgs = bench_images(BATCH, SIZE)
    gate = torch.ones(8, dtype=torch.int32, device=dev)
    gate[2] = gate[5] = 0
    rng = np.random.default_rng(C3_SEED)
    d_c3, c_c3, _, x_c3 = c3_problem(correlated_binary(rng, C3_SIZE, C3_SIZE)
                                     [None], dev)
    tail_c3 = tiled_setup(d_c3, c_c3, x_c3, C3_KW["min_size"])[0][1:]
    r_tail = torch.tensor(rng.standard_normal(
        (1,) + tuple(tail_c3[0].diag.shape[-2:])), dtype=torch.float32,
        device=dev)
    k2_err, lines = 0.0, []
    for label, dtype in ((f"B=8 x {SIZE}^2 fp32", torch.float32),
                         (f"B=8 x {SIZE}^2 fp64", torch.float64),
                         (f"config 3's tail B=1 x {tuple(r_tail.shape[-2:])}"
                          " fp32", None)):
        if dtype is None:
            lv_k, r_k, act, mg = tail_c3, r_tail, None, MG3
        else:
            c_k, _, x_k = build_problem(imgs[:8], dev, dtype)
            lv_k = multigrid.build_hierarchy(c_k, min_size=8, pad_levels=True)
            r_k = lv_k[0].b - fvm.apply_operator(lv_k[0], x_k.contiguous())
            act, mg = gate, MG
        shapes = [tuple(c.diag.shape[-2:]) for c in lv_k]
        item = r_k.element_size()
        n0 = lib.deff_launch_count()
        z_k = v_cycle(lv_k, r_k, active=act, **mg)
        torch.cuda.synchronize()
        per_cycle = lib.deff_launch_count() - n0
        check(per_cycle == cycle_launches(shapes, item),
              f"K2 {label}: {per_cycle} launches, the rule's "
              f"{cycle_launches(shapes, item)}")
        z_p = v_cycle_reference(lv_k, r_k, active=act, **mg)
        err = float((z_k - z_p).abs().max())
        check(bool(torch.equal(z_k, z_p)), f"K2 {label}: max|z_k - z_p| "
              f"{err} (must be bit-equal)")
        k2_err = max(k2_err, err)
        lines.append(f"{label}: max abs err {err:.3e} (max|z| "
                     f"{float(z_p.abs().max()):.3e}), {len(shapes)} levels, "
                     f"resident from level "
                     f"{cycle_resident_from(shapes, item)}, {per_cycle} "
                     f"launches a cycle")
        if dtype == torch.float32:
            lv8, r8, x8 = lv_k, r_k, x_k.contiguous()
    phase(3, t0, "K2 vs plain: " + "; ".join(lines))
    del d_c3, c_c3, x_c3, tail_c3, r_tail, lv_k, r_k, z_k, z_p

    # -- 4: K1 against its plain version, B=8 x 512^2, k=5
    t0 = time.perf_counter()
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
    n0 = lib.deff_launch_count()
    cg_steps(lv8, *(t.clone() for t in state), 0, **MG)
    n1 = lib.deff_launch_count()
    got = cg_steps(lv8, *(t.clone() for t in state), 5, **MG)
    # images 0-4 run all five iterations: launches an iteration
    k1_per_iter = (lib.deff_launch_count() - n1 - (n1 - n0)) / 5
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
    k1_bit = all(bool(torch.equal(g, e)) for g, e in zip(got[:3], ref[:3]))
    k1_bpc = k1_bytes_per_cell(lv8, 4, MG["nu"])
    shapes8 = [tuple(c.diag.shape[-2:]) for c in lv8]
    check(k1_per_iter == 5 + cycle_launches(shapes8, 4, 1),
          f"K1 {k1_per_iter} launches an iteration: three passes, two "
          f"finalizes and {cycle_launches(shapes8, 4, 1)} for the cycle")
    phase(4, t0, f"K1 vs plain: k_done {kd}, max abs err x/r/p {k1_err:.3e} "
          f"(bit-equal {k1_bit}), rz max rel err "
          f"{float(((got[3] - ref[3]) / ref[3]).abs().max()):.3e}; "
          f"{k1_per_iter:g} launches/iteration; reckoned "
          f"{k1_bpc[1]:.1f} B/cell an iteration (with per-sweep K2 levels "
          f"{k1_bpc[0]:.1f})")
    del lv8, x8, r8, p8, got, ref, state

    # -- 5: the MGCG slice at B=512 x 512^2
    t0 = time.perf_counter()
    coeffs, spec, x0 = build_problem(imgs, dev)
    torch.cuda.synchronize()
    v_cycle.launches = 0
    cg_steps.launches = 0
    jacobi_sweeps.launches = 0
    t1 = time.perf_counter()
    res = multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    launches = {"cg_steps": cg_steps.launches, "v_cycle": v_cycle.launches}
    conv = res.conv.cpu().numpy()
    deff5 = res.deff.cpu().numpy()
    iters = res.iters.cpu().numpy()
    check(launches["cg_steps"] > 0 and launches["v_cycle"] > 0,
          f"kernel launches {launches}")
    check(bool(np.all(conv <= SOLVE_KW["tol"])),
          f"{int(np.sum(conv > SOLVE_KW['tol']))} images not converged, "
          f"max conv {conv.max()}")
    check(bool(np.all(np.isfinite(deff5)) and np.all(deff5 > 0)
               and np.all(deff5 <= 1)), f"Deff out of (0, 1]: "
          f"{deff5.min()}..{deff5.max()}")
    phase(5, t0, f"slice: B={BATCH} x {SIZE}^2 solved in {t_first:.3f} s "
          f"(first run), iters {iters.min()}..{iters.max()}, max conv "
          f"{conv.max():.3e}, Deff {deff5.min():.5f}..{deff5.max():.5f}, "
          f"launches {launches}")

    t0 = time.perf_counter()
    sub = slice(0, 16)
    plain = multigrid._mgcg_core(
        type(coeffs)(*(a[sub] for a in coeffs)),
        type(spec)(*(a[sub] for a in spec)), x0[sub], batched=True,
        plain=True, **SOLVE_KW)
    p_deff = plain.deff.cpu().numpy()
    p_iters = plain.iters.cpu().numpy()
    rel = np.abs(deff5[sub] - p_deff) / np.abs(p_deff)
    d_it = np.abs(iters[sub].astype(int) - p_iters.astype(int))
    check(bool(np.all(rel <= 5e-3)), f"Deff vs plain rel err {rel.max()}")
    check(bool(np.all(d_it <= 3)), f"iterations vs plain differ by {d_it.max()}")
    phase(5, t0, f"slice vs plain (16 images): Deff max rel err "
          f"{rel.max():.3e}, iterations max diff {d_it.max()}")

    t0 = time.perf_counter()
    multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t1 = time.perf_counter()
        res = multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    iters = res.iters.cpu().numpy()
    phase(5, t0, f"timed {card}: {BATCH / min(times):.1f} solves/s "
          f"(runs {', '.join(f'{t:.4f}' for t in times)} s), iters "
          f"{iters.min()}..{iters.max()} (mean {iters.mean():.2f}), peak "
          f"memory {peak / 2**30:.2f} GiB")
    del res, plain

    # -- 6: K1/K2 times at the main path's shapes (B=512 x 512^2)
    t0 = time.perf_counter()
    lv = multigrid.build_hierarchy(coeffs, min_size=8, pad_levels=True)
    x = x0.contiguous().clone()
    r = lv[0].b - fvm.apply_operator(lv[0], x)
    shapes = [tuple(c.diag.shape[-2:]) for c in lv]
    n0 = lib.deff_launch_count()
    v_cycle(lv, r, **MG)
    per_cycle = lib.deff_launch_count() - n0
    check(per_cycle == cycle_launches(shapes, 4), f"K2 {per_cycle} launches")
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
    # K2 reads the hierarchy and r, writes z; K1 (k=5, every image active,
    # no early exit) also reads b, x, r, p and writes x, r, p, and does
    # k + 1 cycles (the refresh's one included) plus 22 operations a cell
    # per iteration and 15 in the refresh for the CG updates, dot products
    # and matrix-vector products
    item = x.element_size()
    k2_bytes, k2_ops, cells = cycle_work(lv, BATCH, item, MG["nu"])
    k2_bound = bound(k2_bytes, k2_ops, item)
    k1_bytes = k2_bytes - 2 * item * BATCH * cells[0] + \
        7 * item * BATCH * cells[0]
    k1_ops = 6 * k2_ops + BATCH * cells[0] * (22 * 5 + 15)
    k1_bound = bound(k1_bytes, k1_ops, item)
    k1_bpc = k1_bytes_per_cell(lv, item, MG["nu"])
    phase(6, t0, f"kernel times {card}, B={BATCH} x {SIZE}^2 fp32: "
          f"K2 v_cycle {ms_k2:.3f} ms (plain {ms_k2p:.3f} ms, bound "
          f"{k2_bound[0]:.3f} ms by {k2_bound[1]}, {per_cycle} "
          f"launches/cycle); K1 cg_steps k=5 {ms_k1:.3f} ms (plain "
          f"{ms_k1p:.3f} ms, bound {k1_bound[0]:.3f} ms by {k1_bound[1]}, "
          f"{per_iter:g} launches/iteration, reckoned {k1_bpc[1]:.1f} "
          f"B/cell an iteration: {k1_bpc[1] * BATCH * SIZE**2 / 1e9:.2f} GB, "
          f"{k1_bpc[1] * BATCH * SIZE**2 / HBM_BPS * 1e3:.3f} ms at "
          f"{HBM_BPS / 1e12:.2f} TB/s; with per-sweep K2 levels "
          f"{k1_bpc[0]:.1f} B/cell; the cycle from level 1 "
          f"{cycle_launches(shapes, 4, 1)} launches)")
    prof_k1 = profile_solve(lambda: k1(cg_steps), PROFILE_GROUPS_K1)
    prof_slice = profile_solve(
        lambda: multigrid.solve_mgcg_batched(coeffs, spec, x0, **SOLVE_KW),
        PROFILE_GROUPS_K1)
    phase(6, t0, f"profiles {card}: K1 k=5 call: {profile_line(prof_k1)}; "
          f"one slice solve: {profile_line(prof_slice)}")
    del lv, x, r, p, coeffs, spec, x0
    torch.cuda.empty_cache()

    # -- 7: K3 against its plain version, both routes
    t0 = time.perf_counter()
    k3_err, k3_cases, routes = 0.0, 0, {"resident": 0, "streaming": 0}
    for ny, nx in ((128, 128), (96, 160), (512, 512)):
        k_imgs = bench_images(8, ny, nx, seed=11)
        for dtype in (torch.float32, torch.float64):
            c, _, xk = build_problem(k_imgs, dev, dtype)
            xk = xk.contiguous()
            act = torch.ones(8, dtype=torch.int32, device=dev)
            act[5] = 0
            resident = jacobi_resident_fits(ny, nx, xk.element_size())
            check(resident == (ny < 512), f"K3 route rule at {ny}x{nx}")
            for k in ((1, 37, 10_000) if ny == 128 else (1, 37)):
                n0, l0 = jacobi_sweeps.launches, lib.deff_launch_count()
                r0 = jacobi_sweeps.resident_launches
                got = jacobi_sweeps(c, xk, k, active=act)
                torch.cuda.synchronize()
                want = (1, 0) if resident else (0, k)
                seen = (jacobi_sweeps.resident_launches - r0,
                        jacobi_sweeps.launches - n0)
                check(seen == want and lib.deff_launch_count() - l0 == sum(
                    want), f"K3 {ny}x{nx} k={k} launches (resident, "
                    f"streaming) {seen}, library "
                    f"{lib.deff_launch_count() - l0}")
                ref = jacobi_sweeps_reference(c, xk, k, active=act)
                err = float((got - ref).abs().max())
                check(bool(torch.equal(got, ref)), f"K3 {ny}x{nx} {dtype} "
                      f"k={k}: max abs err {err} (must be bit-equal)")
                check(bool(torch.equal(got[5], xk[5])),
                      "K3 frozen image changed")
                k3_err = max(k3_err, err)
                k3_cases += 1
                routes["resident" if resident else "streaming"] += 1
    phase(7, t0, f"K3 vs plain: {k3_cases} cases (128^2 k=1/37/10000 and "
          f"96x160 k=1/37 on the resident route, one launch a call; 512^2 "
          f"k=1/37 streaming; fp32/fp64; image 5 frozen; cases by route "
          f"{routes}), max abs err {k3_err:.3e}, all bit-equal")

    # -- 8: the CLI batch path at full size on K3
    t0 = time.perf_counter()
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    csv = WORK_DIR / "batch_jacobi.csv"
    csv.unlink(missing_ok=True)              # a stale file would be resumed
    inp = WORK_DIR / "input_jacobi.txt"
    inp.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: {JAC_BATCH}\n"
                   f"Ds: 1e-6\nDf: 1\nSolver: jacobi_pallas\n"
                   f"Convergence: {JAC_TOL}\nMaxIter: {JAC_MAX:.0e}\n"
                   f"OutputName: {csv}\n")
    cfg = parse_input_file(str(inp))
    jimgs = bench_images(JAC_BATCH, JAC_SIZE)
    groups = []                              # (deff, conv, iters, x, dt)
    solve_group = batch.solve_image_group

    def observed(*a, **kw):
        out = solve_group(*a, **kw)
        groups.append(out)
        return out

    batch.solve_image_group = observed       # to read each image's sweeps
    try:
        torch.cuda.synchronize()
        jacobi_sweeps.launches = jacobi_sweeps.resident_launches = 0
        v_cycle.launches = cg_steps.launches = 0
        t1 = time.perf_counter()
        table = batch.batch_sim(cfg, imgs=list(jimgs), device="cuda")
        torch.cuda.synchronize()
        wall8 = time.perf_counter() - t1
        k3_routes = (jacobi_sweeps.resident_launches, jacobi_sweeps.launches)
        k3_launches = sum(k3_routes)
        check(v_cycle.launches == 0 and cg_steps.launches == 0,
              "the jacobi_pallas path launched K1/K2")
    finally:
        batch.solve_image_group = solve_group
    rows = [ln for ln in csv.read_text().splitlines()
            if ln.split(",")[0].isdigit()]
    check(len(rows) == JAC_BATCH, f"{len(rows)} CSV rows, not {JAC_BATCH}")
    check(len(groups) == 1, f"{len(groups)} shape groups")
    sweeps = groups[0][2]
    solve8 = groups[0][4]
    j_deff, j_conv = table[:, 3], table[:, 6]
    done = np.abs(j_conv) <= JAC_TOL
    check(bool(np.all(done | (sweeps == JAC_MAX))),
          f"{int(np.sum(~done & (sweeps != JAC_MAX)))} images stopped "
          "unconverged before MaxIter")
    check(bool(np.all(np.isfinite(j_deff)) and np.all(j_deff > 0)
               and np.all(j_deff <= 1)),
          f"Deff out of (0, 1]: {j_deff.min()}..{j_deff.max()}")
    check(k3_routes[0] > 0 and k3_routes[1] == 0,
          f"K3 launches (resident, streaming) {k3_routes}")
    phase(8, t0, f"CLI batch {card}: {JAC_BATCH} x {JAC_SIZE}^2 fp32 "
          f"jacobi_pallas, {int(done.sum())} converged, "
          f"{int(np.sum(sweeps == JAC_MAX))} at MaxIter, sweeps "
          f"{sweeps.min()}..{sweeps.max()}, Deff {j_deff.min():.5f}.."
          f"{j_deff.max():.5f}, solve {solve8:.3f} s, host and set-up "
          f"{wall8 - solve8:.3f} s, K3 launches {k3_launches} (resident "
          f"{k3_routes[0]}, streaming {k3_routes[1]})")

    t0 = time.perf_counter()
    c, s, xk = build_problem(jimgs[:8], dev)
    kw = dict(tol=JAC_TOL, max_iter=JAC_CAP, check_every=10_000,
              criterion="deff")
    kern = jacobi_pallas.solve_jacobi_pallas_batched(c, s, xk, **kw)
    plain = driver.run_batched(
        lambda xx, k, a: jacobi_sweeps_reference(c, xx, k, active=a), c, s,
        xk.contiguous(), **kw)
    rel = np.abs(kern.deff.cpu().numpy() - plain.deff.cpu().numpy()) / \
        np.abs(plain.deff.cpu().numpy())
    check(kern.iters.tolist() == plain.iters.tolist(),
          f"K3 iterations {kern.iters.tolist()} vs plain "
          f"{plain.iters.tolist()}")
    check(bool(np.all(rel <= 1e-6)), f"K3 Deff vs plain rel err {rel.max()}")
    phase(8, t0, f"8 images vs K3's plain version at {JAC_CAP} sweeps: "
          f"iterations equal, Deff max rel err {rel.max():.3e}")

    # -- 9: BASELINE config 1 (one 128^2 image, fp64, reference protocol)
    t0 = time.perf_counter()
    cfg1 = SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=1e-6,
                            dtype="float64", solver="jacobi_pallas",
                            convergence=JAC_TOL, max_iter=JAC_MAX)
    jacobi_sweeps.launches = jacobi_sweeps.resident_launches = 0
    r1 = single.single_sim(cfg1, img=jimgs[0], write_output=False,
                           device="cuda")
    torch.cuda.synchronize()
    k3_c1 = (jacobi_sweeps.resident_launches, jacobi_sweeps.launches)
    check(k3_c1[0] > 0 and k3_c1[1] == 0,
          f"config 1 K3 launches (resident, streaming) {k3_c1}")
    check(np.isfinite(r1.deff) and 0 < r1.deff <= 1, f"Deff {r1.deff}")
    check(abs(r1.conv) <= JAC_TOL or r1.iters == JAC_MAX,
          f"conv {r1.conv} after {r1.iters} sweeps")
    phase(9, t0, f"BASELINE config 1 {card}: 128^2 fp64 jacobi_pallas, "
          f"Deff {r1.deff:.6f}, conv {r1.conv:.3e}, {r1.iters} sweeps, "
          f"solve {r1.time_s:.3f} s, porosity {r1.porosity:.4f}, PathFlag "
          f"{int(r1.path_flag)}, K3 launches {sum(k3_c1)} (resident "
          f"{k3_c1[0]}, streaming {k3_c1[1]})")

    t0 = time.perf_counter()
    capped = {}
    for solver in ("jacobi", "jacobi_pallas"):
        capped[solver] = single.single_sim(
            SimulationConfig(n_phase=2, d_fluid=1.0, d_solid=1e-6,
                             dtype="float64", solver=solver,
                             convergence=JAC_TOL, max_iter=JAC_CAP),
            img=jimgs[0], write_output=False, device="cuda")
    xa, xb = capped["jacobi"].x, capped["jacobi_pallas"].x
    x_err = float(np.abs(xa - xb).max())
    check(x_err <= 1e-9 * float(np.abs(xa).max()),
          f"plain sweep vs K3 at {JAC_CAP} sweeps: max|dx| {x_err}")
    check(capped["jacobi"].iters == capped["jacobi_pallas"].iters,
          "plain sweep vs K3 iterations")
    slabs = []
    for n_phase, img, want in (
            (2, img_io.parallel_slab(JAC_SIZE, 0.5), 0.5 + 0.5 * 1e-6),
            (3, img_io.three_phase_parallel_slab(JAC_SIZE, 0.25, 0.5),
             0.5 + 0.25 * 200.0)):
        cfg_s = SimulationConfig(n_phase=n_phase, d_fluid=1.0,
                                 d_solid=1e-6 if n_phase == 2 else 0.0,
                                 d_gas=200.0, dtype="float64",
                                 solver="jacobi_pallas")
        run = single.single_sim if n_phase == 2 else single.single_sim_3phase
        got_s = run(cfg_s, img=img, write_output=False, device="cuda").deff
        check(abs(got_s - want) <= 1e-5 * abs(want),
              f"{n_phase}-phase slab Deff {got_s} vs {want}")
        slabs.append(abs(got_s - want) / abs(want))
    phase(9, t0, f"plain sweep vs K3 at {JAC_CAP} sweeps: max|dx| "
          f"{x_err:.3e}; slabs vs analytic Deff: rel err 2-phase "
          f"{slabs[0]:.3e}, 3-phase {slabs[1]:.3e}")

    # -- 10: the CLI batch path with Solver: mgcg on 64 of phase 5's images
    t0 = time.perf_counter()
    csv10 = WORK_DIR / "batch_mgcg.csv"
    csv10.unlink(missing_ok=True)
    inp10 = WORK_DIR / "input_mgcg.txt"
    inp10.write_text(f"Phases: 2\nRunBatch: 1\nNumImages: 64\n"
                     f"Ds: {CONTRAST}\nDf: 1\nSolver: mgcg\n"
                     f"Criterion: residual\nConvergence: 1e-6\n"
                     f"OutputName: {csv10}\n")
    cfg10 = parse_input_file(str(inp10))
    v_cycle.launches = cg_steps.launches = 0
    table10 = batch.batch_sim(cfg10, imgs=list(imgs[:64]), device="cuda")
    torch.cuda.synchronize()
    mg_launches = {"cg_steps": cg_steps.launches, "v_cycle": v_cycle.launches}
    check(mg_launches["cg_steps"] > 0 and mg_launches["v_cycle"] > 0,
          f"mgcg batch launches {mg_launches}")
    conv10 = table10[:, 6]
    check(bool(np.all(conv10 <= 1e-6)), f"mgcg batch max conv {conv10.max()}")
    # the CLI path must compute what the solver computes with the
    # pipeline's settings (V(1,1), windows of 10): same kernels, same data
    c, s, xk = build_problem(imgs[:64], dev)
    direct = dispatch.solve_batched(
        "mgcg", c, s, xk, omega=cfg10.omega, tol=cfg10.convergence,
        max_iter=cfg10.max_iter, check_every=cfg10.check_every,
        criterion=cfg10.criterion, first_window=cfg10.first_window)
    d_direct = direct.deff.cpu().numpy().astype(np.float64)
    rel_direct = np.abs(table10[:, 3] - d_direct) / d_direct
    check(bool(np.all(rel_direct <= 1e-6)), f"mgcg batch Deff vs the direct "
          f"solve rel err {rel_direct.max()}")
    # against phase 5 (V(2,2), windows of 40): both stop at mean|r| <= 1e-6,
    # which bounds Deff only to a few percent with the pipeline's V(1,1)
    # settings (PERF.md, Findings); a sanity bound, not an agreement check
    rel10 = np.abs(table10[:, 3] - deff5[:64]) / deff5[:64]
    check(bool(np.all(rel10 <= 0.1)), f"mgcg batch Deff vs phase 5 rel err "
          f"{rel10.max()}")
    phase(10, t0, f"CLI batch mgcg: 64 x {SIZE}^2, max conv "
          f"{conv10.max():.3e}, Deff vs the direct solve max rel err "
          f"{rel_direct.max():.3e}, vs phase 5 max rel err {rel10.max():.3e} "
          f"(median {np.median(rel10):.3e}), solve "
          f"{table10[:, 4].sum():.3f} s, launches {mg_launches}")

    # -- 11: K3 times (CUDA events), K3_TIME_K sweeps a call, the resident
    # and the streaming route in turns (resident, streaming, streaming,
    # resident), at the CLI batch's and config 1's shapes
    t0 = time.perf_counter()
    k3_times = {}
    for n_img, dtype in ((JAC_BATCH, torch.float32), (1, torch.float64)):
        label = f"B={n_img}x{JAC_SIZE}^2 {str(dtype)[-7:]}"
        c, _, xk = build_problem(jimgs[:n_img], dev, dtype)
        xk = xk.contiguous()
        w = 2.0 / 3.0

        def res_call():
            return k3mod._resident(c, xk, K3_TIME_K, w, None)

        def str_call():
            return k3mod._streaming(c, xk, K3_TIME_K, w, None)

        check(bool(torch.equal(res_call(), str_call())),
              f"K3 {label}: the routes differ")
        turns = [cuda_ms(f, 3) for f in (res_call, str_call, str_call,
                                         res_call)]
        ms_p = cuda_ms(lambda: jacobi_sweeps_reference(c, xk, K3_TIME_K), 1)
        item = xk.element_size()
        cells = xk.numel()
        # reads a_w, a_n, diag_inv, b and x once, writes the result once;
        # 12 operations a cell a sweep (4 products and 4 sums for num,
        # then 3 products and 1 sum)
        k3_times[label] = (min(turns[0], turns[3]), min(turns[1], turns[2]),
                           ms_p, turns, bound(6 * item * cells,
                                              12 * cells * K3_TIME_K, item))
    prof_c1 = profile_solve(lambda: single.single_sim(
        cfg1, img=jimgs[0], write_output=False, device="cuda"),
        PROFILE_GROUPS_K3)
    csv.unlink(missing_ok=True)
    prof_batch = profile_solve(lambda: batch.batch_sim(
        cfg, imgs=list(jimgs), device="cuda"), PROFILE_GROUPS_K3)
    phase(11, t0, f"profiles {card}: config 1: {profile_line(prof_c1)}; "
          f"the CLI batch: {profile_line(prof_batch)}")
    t0 = time.perf_counter()
    phase(11, t0, f"K3 times {card}, {K3_TIME_K} sweeps a call: " + "; ".join(
        f"{lb} resident {mr / K3_TIME_K * 1e3:.3f} us/sweep, streaming "
        f"{ms / K3_TIME_K * 1e3:.3f} us/sweep (turns "
        f"{', '.join(f'{t:.3f}' for t in tr)} ms), plain "
        f"{mp / K3_TIME_K * 1e3:.2f} us/sweep; bound {bd[0]:.3f} ms a call "
        f"by {bd[1]}" for lb, (mr, ms, mp, tr, bd) in k3_times.items()))
    del c, xk
    torch.cuda.empty_cache()
    c3_ref, tiled_rows = large_grid_phases(dev, card, lib)
    torch.cuda.empty_cache()
    volume_rows = volume_phases(dev, card, lib)
    torch.cuda.empty_cache()
    sharded_rows = sharded_phases(dev, card, lib, c3_ref["stored"],
                                  imgs[:64], inp10.read_text(), table10)
    torch.cuda.empty_cache()
    krylov_phases(dev, card, lib)
    torch.cuda.empty_cache()
    solver_matrix_phases(dev, card, lib)
    torch.cuda.empty_cache()
    slice7_phases(dev, card, imgs, min(times))
    torch.cuda.empty_cache()
    general_cycle_phases(dev, card, imgs[:64], inp10.read_text(), table10)
    print(f"all phases {time.perf_counter() - t_all:.1f} s", flush=True)

    k3_ms, _, k3_ms_p, _, k3_bound = next(iter(k3_times.values()))
    kernels = [
        {"name": "cg_steps_three_pass", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/cgstep.cu",
         "replaces": "effectivediffusivityfvm_tpu/ops/kernels/cgstep_vmem.py:166",
         "launches": launches["cg_steps"], "max_abs_err": k1_err,
         "ms": ms_k1, "plain_ms": ms_k1p, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "v_cycle", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/vcycle.cu",
         "replaces": "effectivediffusivityfvm_tpu/ops/kernels/vcycle_vmem.py:276",
         "launches": launches["v_cycle"], "max_abs_err": k2_err,
         "ms": ms_k2, "plain_ms": ms_k2p, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "jacobi_sweeps_resident", "route": "cuda",
         "source": "effectivediffusivityfvm_tpu_torch/csrc/jacobi.cu",
         "replaces": "effectivediffusivityfvm_tpu/ops/kernels/jacobi_vmem.py:72",
         "launches": k3_launches, "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_ms_p, "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None},
    ] + tiled_rows + volume_rows + sharded_rows
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
