"""Deff solves of the window's whole requests over the window's seconds
(host clock: from the first request's start to the last one's end)."""


def read(run):
    return sum(r["solves"] for r in run.requests) / run.window_s
