"""The traced run: ``torch.profiler`` over the window, reduced to the device's
activity, the benchmark's own spans and the host ops beside them.

Times are nanoseconds in the profiler's clock.  The benchmark's spans are
``record_function`` ranges named ``pb:<layer>``; the window is ``pb:window``
and each request ``pb:request``.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import List, NamedTuple, Optional

import torch

SPAN = "pb:"


class Event(NamedTuple):
    start: int
    end: int
    name: str


class Trace(NamedTuple):
    device: List[Event]          # kernels, copies and fills, by start
    spans: List[Event]           # the benchmark's pb: ranges, by start
    host: List[Event]            # the program's host ops, by start
    window: Event                # pb:window


def span(name: str):
    """A ``pb:<name>`` range in the traced run (a no-op cost otherwise)."""
    return torch.profiler.record_function(SPAN + name)


def profiler(enabled: bool):
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _ns(e, what):
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


def reduce(prof) -> Optional[Trace]:
    """The profile as a :class:`Trace`, or None where it holds no window."""
    from torch.autograd import DeviceType

    device, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        ev = Event(start, start + _ns(e, "duration"), e.name())
        if e.device_type() == DeviceType.CUDA:
            # not the device-side copies of the ranges, nor the profiler's
            # own buffer requests
            note = getattr(e, "is_user_annotation", lambda: False)()
            if not (note or ev.name.startswith(SPAN) or "Buffer" in ev.name):
                device.append(ev)
        elif ev.name.startswith(SPAN):
            spans.append(ev)
        else:
            host.append(ev)
    windows = [s for s in spans if s.name == SPAN + "window"]
    if not windows:
        return None
    for lst in (device, spans, host):
        lst.sort()
    return Trace(device, spans, host, windows[0])


def merged(events: List[Event], lo: int, hi: int) -> List[tuple]:
    """The union of the events' intervals, clipped to ``[lo, hi]``."""
    out = []
    for e in events:
        s, t = max(e.start, lo), min(e.end, hi)
        if s >= t:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


class Busy:
    """Device-busy nanoseconds within any interval, from the union."""

    def __init__(self, tr: Trace):
        self.iv = merged(tr.device, tr.window.start, tr.window.end)
        self.starts = [s for s, _ in self.iv]
        self.cum = [0]
        for s, t in self.iv:
            self.cum.append(self.cum[-1] + t - s)

    def within(self, lo: int, hi: int) -> int:
        i = max(0, bisect.bisect_right(self.starts, lo) - 1)
        j = bisect.bisect_left(self.starts, hi)
        total = self.cum[j] - self.cum[i]
        if i < len(self.iv):                     # clip the first interval
            s, t = self.iv[i]
            total -= max(0, min(t, lo) - s)
        if j > i:                                # and the last
            s, t = self.iv[j - 1]
            total -= max(0, t - max(s, hi))
        return max(0, total)

    def total(self) -> int:
        return self.cum[-1]


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    arguments."""
    bare = name.replace("(anonymous namespace)::", "").replace("void ", "")
    cut = min((i for i in (bare.find("<"), bare.find("(")) if i > 0),
              default=len(bare))
    return bare[:cut].split("::")[-1].strip() or name


def in_window(tr: Trace) -> List[Event]:
    return [e for e in tr.device
            if e.end > tr.window.start and e.start < tr.window.end]


def device_ops(tr: Trace, top: int = 10) -> list:
    """``[[kernel, seconds], ...]``: the device time by short name."""
    tot = {}
    for e in in_window(tr):
        k = short(e.name)
        tot[k] = tot.get(k, 0) + e.end - e.start
    return [[k, v / 1e9] for k, v in sorted(tot.items(),
                                              key=lambda kv: -kv[1])[:top]]


def _innermost(events: List[Event], points: List[int]) -> List[str]:
    """For each of the sorted ``points``, the innermost event around it (the
    one that started last among those still running), or ''."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i].start <= p:
            stack.append(events[i])
            i += 1
        alive = [e for e in stack if e.end >= p]
        stack = alive
        out.append(alive[-1].name if alive else "")
    return out


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """``[[what the host did, seconds], ...]``: the device's idle time in the
    window, summed by the benchmark's span and the program's host op that
    were running at each gap's middle."""
    busy = merged(tr.device, tr.window.start, tr.window.end)
    edges = [tr.window.start] + [x for iv in busy for x in iv] + \
        [tr.window.end]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    mids = [(s + t) // 2 for s, t in gaps]
    inner_span = _innermost([s for s in tr.spans if s.name != SPAN + "window"],
                            mids)
    inner_op = _innermost(tr.host, mids)
    tot = {}
    for (s, t), sp, op in zip(gaps, inner_span, inner_op):
        key = f"{sp[len(SPAN):] or 'window'}/{op or 'python'}"
        tot[key] = tot.get(key, 0) + t - s
    return [[k, v / 1e9] for k, v in sorted(tot.items(),
                                              key=lambda kv: -kv[1])[:top]]


# K1's kernels (csrc/cgstep.cu): a call opens with set_act_kernel (after a
# fill of level 1's residual) and closes with fin_refresh_kernel; the K2
# cycle kernels between them run inside K1.  K2's own kernels
# (csrc/vcycle.cu, csrc/levelpass2d.cuh) outside a K1 call are its own calls.
K1_OPEN, K1_CLOSE = "set_act_kernel", "fin_refresh_kernel"
K2_NAMES = ("level_down", "level_up", "bottom_kernel", "coarse_solve",
            "smooth_kernel", "resid_restrict", "post_first")
K3_NAMES = ("jacobi_resident", "jacobi_sweep_kernel")


def split_k1_k2(tr: Trace):
    """``(K1 ns, K2 ns)`` of device time in the window: every activity from
    a K1 call's opening fill or kernel to its closing kernel is K1's; K2's
    kernels outside those calls are K2's."""
    ev = in_window(tr)
    k1 = k2 = 0
    inside = False
    for n, e in enumerate(ev):
        dur = e.end - e.start
        if K1_OPEN in e.name:
            inside = True
            if n and "emset" in ev[n - 1].name:
                k1 += ev[n - 1].end - ev[n - 1].start
        if inside:
            k1 += dur
            if K1_CLOSE in e.name:
                inside = False
        elif any(k in e.name for k in K2_NAMES):
            k2 += dur
    return k1, k2


def kernel_ns(tr: Trace, names) -> int:
    return sum(e.end - e.start for e in in_window(tr)
               if any(k in e.name for k in names))
