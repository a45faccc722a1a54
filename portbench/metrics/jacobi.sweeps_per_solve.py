"""Mean sweeps of the window's Jacobi solves (the solves' iteration
counts, as ``batch_sim``'s group solve returns them)."""

import numpy as np


def read(run):
    if run.work.get("kind") != "jacobi":
        return None
    return float(np.mean(np.concatenate([r["iters"] for r in run.requests])))
