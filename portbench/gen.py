"""The one traffic generator: media made on the device from the run's seed.

A medium is 2-phase, as ``bench.py`` draws it: standard normal noise
smoothed by a Gaussian of ``sigma`` pixels (reflecting borders, the kernel
cut at four sigma), the ``1 - porosity`` share of the largest values solid
and the rest fluid.  Every image of a seed has exactly the same porosity;
the seed only moves the pores.

A traffic file (``traffic/<name>.json``) gives the sizes: the pool of
distinct inputs made at set-up, and what a request takes from it.  Requests
take the pool round-robin, so a window never repeats an input back to back
and every seed sends the same sizes in the same order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 64                 # images smoothed and ranked per call


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A torch generator on ``device`` for one stream of the seed."""
    gen = torch.Generator(device=device)
    mixed = np.random.SeedSequence([int(seed) % 2**63, stream])
    gen.manual_seed(int(mixed.generate_state(1, np.uint64)[0]) >> 1)
    return gen


def host_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for the host's draws (samples) of one stream."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def _kernel(sigma: float, device) -> torch.Tensor:
    radius = int(4.0 * sigma + 0.5)
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    return k / k.sum()


def solid_masks(gen: torch.Generator, count: int, size: int, *, sigma: float,
                porosity: float) -> torch.Tensor:
    """``(count, size, size)`` bool on the generator's device, True where
    solid."""
    dev = gen.device
    k = _kernel(sigma, dev)
    r = (k.numel() - 1) // 2
    n_solid = int(round((1.0 - porosity) * size * size))
    out = torch.empty((count, size, size), dtype=torch.bool, device=dev)
    for s in range(0, count, CHUNK):
        n = min(CHUNK, count - s)
        noise = torch.randn((n, 1, size, size), generator=gen, device=dev)
        noise = F.conv2d(F.pad(noise, (r, r, 0, 0), mode="reflect"),
                         k.view(1, 1, 1, -1))
        noise = F.conv2d(F.pad(noise, (0, 0, r, r), mode="reflect"),
                         k.view(1, 1, -1, 1))
        flat = noise.view(n, -1)
        solid = torch.zeros_like(flat, dtype=torch.bool)
        solid.scatter_(1, torch.topk(flat, n_solid, dim=1).indices, True)
        out[s:s + n] = solid.view(n, size, size)
    return out


def pixels(solid: torch.Tensor) -> torch.Tensor:
    """8-bit grayscale images: 255 where solid, 0 in the pores."""
    return solid.to(torch.uint8) * 255


def round_robin(k: int, pool: int) -> int:
    """The pool entry request ``k`` takes."""
    return k % pool
