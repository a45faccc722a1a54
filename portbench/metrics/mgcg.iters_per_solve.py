"""Mean PCG iterations of the window's MGCG solves (``SolveResult.iters``)."""

import numpy as np


def read(run):
    if run.work.get("kind") != "mgcg":
        return None
    return float(np.mean(np.concatenate([r["iters"] for r in run.requests])))
