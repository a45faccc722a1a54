"""K3's share of its roofline in percent: the least time of the window's
sweeps (``work.k3_call_work``: each image's sweeps from the solves, one call
a check window) over the device time of K3's kernels in the trace."""

from portbench import trace, work


def read(run):
    w, tr = run.work, run.trace
    if tr is None or w.get("kind") != "jacobi":
        return None
    k3_ns = trace.kernel_ns(tr, trace.K3_NAMES)
    if k3_ns <= 0:
        return None
    nbytes = ops = 0.0
    for r in run.requests:
        for s in r["iters"]:
            b, o = work.k3_call_work(w["cells"], w["itemsize"], int(s))
            nbytes += b * work.jacobi_windows(int(s), w["check_every"])
            ops += o
    return 100.0 * work.bound_s(nbytes, ops, w["itemsize"]) / (k3_ns / 1e9)
