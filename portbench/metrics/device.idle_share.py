"""Share of the traced window in which no kernel, copy or fill ran on the
device (the union of their intervals, from the profiler), in percent."""

from portbench.trace import Busy


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = Busy(tr).total()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (tr.window.end - tr.window.start))
