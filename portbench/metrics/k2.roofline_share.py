"""K2's share of its roofline in percent, for its own calls (not the cycles
inside K1): one whole cycle on every image of a solve (the fresh start), by
``work.cycle_work``, over the device time of K2's kernels outside K1's
calls (``trace.split_k1_k2``)."""

from portbench import trace, work


def read(run):
    w, tr = run.work, run.trace
    if tr is None or w.get("kind") != "mgcg":
        return None
    _, k2_ns = trace.split_k1_k2(tr)
    if k2_ns <= 0:
        return None
    solves = sum(r["solves"] for r in run.requests)
    nbytes, ops = work.cycle_work(w["cells"], solves, w["itemsize"], w["nu"])
    return 100.0 * work.bound_s(nbytes, ops, w["itemsize"]) / (k2_ns / 1e9)
