"""95th percentile of the window's request latencies in milliseconds (host
clock, from a request's start to its Deff on the host), over every request
of the window; the count is on the run's standard error."""

import numpy as np


def read(run):
    lat = [r["t1"] - r["t0"] for r in run.requests]
    return float(np.percentile(lat, 95)) * 1e3
