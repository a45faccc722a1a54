"""Milliseconds a request in which the device ran nothing: each request's
span less the device-busy time inside it (profiler), averaged."""

from portbench.trace import SPAN, Busy


def read(run):
    tr = run.trace
    if tr is None or run.work.get("kind") != "mgcg":
        return None
    busy = Busy(tr)
    reqs = [s for s in tr.spans if s.name == SPAN + "request"]
    if not reqs or busy.total() <= 0:
        return None
    idle = [(s.end - s.start) - busy.within(s.start, s.end) for s in reqs]
    return sum(idle) / len(idle) / 1e6
