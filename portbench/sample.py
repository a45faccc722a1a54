"""The sample of answers the output check judges: a reservoir, drawn from the
seed, over every answer of the window, and beside it the answer that took
the most iterations."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """A uniform sample of ``size`` answers of a stream (algorithm R)."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size = size
        self.rng = rng
        self.seen = 0
        self.slots = {}                 # slot -> what ``keep`` returned
        self.longest = None             # (iterations, what keep returned)

    def offer(self, count: int, keep, iters=None):
        """Offer ``count`` answers; ``keep(i)`` makes what a chosen answer
        ``i`` (0-based in this offer) is kept as.  ``iters``, if given, the
        answers' iteration counts, keeps the longest answer too."""
        pos = self.seen + np.arange(count)
        draw = np.where(pos < self.size, pos,
                        self.rng.integers(0, pos + 1))
        for i in np.flatnonzero(draw < self.size):
            self.slots[int(draw[i])] = keep(int(i))
        self.seen += count
        if iters is not None and count:
            i = int(np.argmax(iters))
            if self.longest is None or iters[i] > self.longest[0]:
                self.longest = (int(iters[i]), keep(i))

    def items(self) -> list:
        """The kept answers, the longest last (it may also be sampled)."""
        out = [self.slots[k] for k in sorted(self.slots)]
        if self.longest is not None:
            out.append(self.longest[1])
        return out
