#!/usr/bin/env python3
"""The control of each cell's output check, computed in the precision below
the configuration's (``LOWER``) and judged by the same check.  It must come
out not correct.  Where the program runs that precision (float32 under a
float64 configuration) the program's own path is the control; where it does
not (bfloat16 under float32), the plain reference in that precision takes
the program's place.  The benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed ...]

For each seed it makes the cell's inputs as a run does, draws the sample a
run of ``--requests`` requests would judge, answers it with the entry's
``control`` and prints one JSON line of the check's numbers and limits.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


# the nearest precision below each configuration's
LOWER = {"float64": "float32", "float32": "bfloat16"}
# the precisions the program runs (``SimulationConfig.dtype``)
PROGRAM_DTYPES = ("float32", "float64")


def lower_dtype(config: dict) -> str:
    """The control's precision for ``config``; a precision with none below
    it in ``LOWER`` is refused by name."""
    try:
        return LOWER[config["dtype"]]
    except KeyError:
        raise ValueError(f"no control precision below {config['dtype']!r}; "
                         f"known: {', '.join(LOWER)}") from None


def control_checks(plan, seed: int, device, requests: int) -> list:
    import importlib

    mod = importlib.import_module(
        f"portbench.entries.{plan.traffic['entry']}")
    entry = mod.Entry(plan.config, plan.traffic, int(seed), device)
    for k in range(requests):
        entry.kept.offer(entry.per_request, lambda i, k=k: (k, i))
    picks = entry.kept.items()
    answers = entry.control(picks)
    entry.kept.slots = dict(enumerate(answers))
    entry.release()
    return entry.check()


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import harness

    plan = harness.cell_plan(harness.benchmark(), args.workload)
    for seed in args.seed:
        t0 = time.perf_counter()
        checks = control_checks(plan, seed, args.device, args.requests)
        fails = [n for n, v, lim in checks if not v <= lim]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": not fails, "seconds":
                          time.perf_counter() - t0, "checks": {
                              n: {"value": v, "limit": lim}
                              for n, v, lim in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main(sys.argv[1:]))
