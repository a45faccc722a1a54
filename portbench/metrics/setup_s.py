"""Seconds from the process's start to the first timed request: imports,
the kernel library's load (its build in a checkout's first run), the
inputs made from the seed and the cell's shapes warmed once."""


def read(run):
    return run.setup_s
