"""The benchmark's one driver, led by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.  The
configuration's file (``configs/<config>.json``) holds the deployment's
physics, medium, solver settings and the limits of its output check; the
traffic's file (``traffic/<traffic>.json``) names the entry that serves a
request (``entries/<entry>.py``) and the sizes.  Each metric is read by its
own file, ``metrics/<metric>.py``.  A new cell, configuration, traffic mix
or metric is a new file and an entry in ``BENCHMARK.json``.

A run: set-up (the entry makes its inputs from the seed and warms the cell's
shapes once), the window (whole requests, one after the other, until
``seconds`` have passed; with ``trace`` under ``torch.profiler``), the
memory peak, the program's state freed, then the output check against the
plain reference in ``reference/`` and the metrics.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from . import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "effectivediffusivityfvm_tpu")


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def metric_file(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or, where there
    is none, that of ``name`` less its last dotted part.  One reading that
    moves another end-to-end metric in other cells takes a name of its own
    there and no file of its own: ``device.idle_share.pipeline`` is read by
    ``device.idle_share.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no metric file for {name!r} under "
                                f"{HERE / 'metrics'}")
    return path


def load_metric(name: str):
    """The reader of metric ``name`` (``metric_file``) as a module, by its
    path (a metric's name may hold dots)."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_plan(bench: dict, name: str) -> SimpleNamespace:
    """The cell's configuration and traffic files and the metrics it
    reports, by ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return SimpleNamespace(cell=cell, config=config, traffic=traffic,
                           end_to_end=mine(bench["end_to_end"]),
                           per_layer=mine(bench["per_layer"]))


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux ``/proc``)."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def run_cell(plan, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Set up, warm, run the window, check and read the metrics; returns
    the result line's fields (``device`` without the card's name)."""
    import torch

    entry_mod = importlib.import_module(
        f"portbench.entries.{plan.traffic['entry']}")
    stamps = [("start", t_start), ("imported", time.time())]
    entry = entry_mod.Entry(plan.config, plan.traffic, int(seed), device,
                            traced=trace)
    stamps.append(("inputs made", time.time()))
    entry.warm_up()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    stamps.append(("warmed", time.time()))
    requests = []
    with tr.profiler(trace) as prof:
        with tr.span("window"):
            t_first = time.time()
            t0 = time.perf_counter()
            k = 0
            while k == 0 or time.perf_counter() - t0 < seconds:
                with tr.span("request"):
                    ts = time.perf_counter()
                    handle = entry.request(k)
                    te = time.perf_counter()
                with tr.span("after"):
                    rec = entry.after(k, handle)
                rec.update(t0=ts - t0, t1=te - t0)
                requests.append(rec)
                k += 1
            t1 = time.perf_counter()
    stamps.append(("window", time.time()))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = tr.reduce(prof) if trace else None
    stamps.append(("trace read", time.time()))
    entry.release()
    checks = entry.check()
    stamps.append(("checked", time.time()))
    correct = bool(checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    run = SimpleNamespace(requests=requests, window_s=t1 - t0,
                          setup_s=t_first - t_start, trace=traced,
                          work=entry.work(), config=plan.config,
                          traffic=plan.traffic)
    wanted = plan.per_layer if trace else plan.end_to_end
    metrics = {}
    for m in wanted:
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct,
           "attempted": sum(r["solves"] for r in requests),
           "failed": sum(r["failed"] for r in requests),
           "metrics": metrics,
           "device": {"memory_peak_bytes": int(peak)},
           "requests": len(requests)}
    if traced is not None:
        busy = tr.Busy(traced)
        out["device"].update(busy_s=busy.total() / 1e9,
                             window_s=(traced.window.end
                                       - traced.window.start) / 1e9)
        out["breakdown"] = {"device_ops": tr.device_ops(traced),
                            "idle_gaps": tr.idle_gaps(traced)}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    out["stages"] = ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                              for a, b in zip(stamps, stamps[1:]))
    return out


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card (the roofline
    shares are stated against the peaks at 700 W)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="portbench: one run of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    plan = cell_plan(benchmark(), args.workload)
    import torch

    chips = int(plan.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(plan, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": chips, **out["device"]}
    checks = out.pop("checks")
    print(f"portbench: card {card_line()}", file=sys.stderr)
    print(f"portbench: stages: {out.pop('stages')}", file=sys.stderr)
    print(f"portbench: {out.pop('requests')} requests in the window, "
          f"{out['attempted']} solves", file=sys.stderr)
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
