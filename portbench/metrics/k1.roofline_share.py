"""K1's share of its roofline in percent: the least time the work of the
window's K1 calls needs (``work.k1_call_work``: live iterations of each
image from the solves' ``iters``, calls from the window lengths) over K1's
device time in the trace (``trace.split_k1_k2``)."""

import numpy as np

from portbench import trace, work


def read(run):
    w, tr = run.work, run.trace
    if tr is None or w.get("kind") != "mgcg":
        return None
    k1_ns, _ = trace.split_k1_k2(tr)
    if k1_ns <= 0:
        return None
    iters = np.concatenate([r["iters"] for r in run.requests])
    calls = np.array([work.k1_calls(int(i), w["first_window"], w["window"])
                      for i in iters])
    b0, o0 = work.k1_call_work(w["cells"], w["itemsize"], w["nu"], 0)
    _, o1 = work.k1_call_work(w["cells"], w["itemsize"], w["nu"], 1)
    nbytes = float(calls.sum()) * b0
    ops = float(calls.sum()) * o0 + float(iters.sum()) * (o1 - o0)
    return 100.0 * work.bound_s(nbytes, ops, w["itemsize"]) / (k1_ns / 1e9)
