"""Device meshes, their collectives, and placing global arrays on them
(torch port of ``effectivediffusivityfvm_tpu.parallel.mesh``).

The scale axes are the JAX package's:

  * ``dp`` (data parallel): the image batch, split across mesh rows;
  * ``sp`` (spatial): a domain split by rows across the shards of a mesh
    row, with halo strips exchanged between neighbouring shards.

JAX's ``shard_map`` is single-controller: one process drives every shard.
The port does the same.  A :class:`Mesh` is a ``(dp, sp)`` grid of
``torch.device`` entries, and a device may repeat (four shards on one card
run every exchange on that card; a list of CPU entries runs them in the
tests).  A sharded array is a nested list ``xs[d][s]`` of per-shard
tensors, shard ``(d, s)`` on ``mesh.devices[d * sp + s]``; a "row" is the
list ``xs[d]`` of one dp group.  The collectives below act on one row and
are plain tensor operations:

  * :func:`halo_strips` (``ppermute`` of h-row strips, zeros at the global
    top and bottom): copies between neighbouring shards;
  * :func:`psum`: the sum of the per-shard partials, which every shard then
    reads;
  * :func:`all_gather`: a ``cat`` of the rows;
  * the shard index ``s`` plays ``axis_index``.

A copy between two shards on one device is a device-to-device copy; on two
devices it is a peer copy.  No process group is involved.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = ["Mesh", "make_mesh", "default_devices", "halo_strips", "psum",
           "all_gather", "shard_rows", "shard_batch", "gather_rows"]


class Mesh:
    """A ``(dp, sp)`` grid of torch devices, row-major: shard ``(d, s)``
    lives on ``devices[d * sp + s]``."""

    def __init__(self, devices: Sequence, dp: int, sp: int):
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != dp * sp:
            raise ValueError(f"{len(self.devices)} devices for a "
                             f"({dp}, {sp}) mesh")
        self.dp, self.sp = dp, sp

    def row(self, d: int) -> List[torch.device]:
        """The devices of dp group ``d``."""
        return self.devices[d * self.sp:(d + 1) * self.sp]


def default_devices() -> List[torch.device]:
    """Every visible CUDA device."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, dp: int = 1,
              sp: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(dp, sp)`` mesh over ``devices`` (default: every visible
    CUDA device).  ``sp`` defaults to ``n_devices // dp``."""
    if devices is None:
        devices = default_devices()
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices requested, {len(devices)} "
                         "given")
    devices = devices[:n_devices]
    if sp is None:
        if n_devices % dp:
            raise ValueError(f"dp={dp} does not divide n_devices={n_devices}")
        sp = n_devices // dp
    if dp * sp != n_devices:
        raise ValueError(f"dp*sp={dp*sp} != n_devices={n_devices}")
    return Mesh(devices, dp, sp)


# ----------------------------------------------------------- collectives

def halo_strips(xs: Sequence[torch.Tensor], h: int, out=None):
    """``(norths, souths)`` of a row of shards ``(..., ny_l, nx)``: shard
    ``s`` receives shard ``s-1``'s last ``h`` rows as its north strip and
    shard ``s+1``'s first ``h`` rows as its south strip; the strips beyond
    the global top and bottom are zeros.  ``out = (norths, souths)`` reuses
    strip buffers (their edge entries must hold zeros)."""
    n = len(xs)
    if out is None:
        norths = [x.new_zeros(x.shape[:-2] + (h, x.shape[-1])) for x in xs]
        souths = [x.new_zeros(x.shape[:-2] + (h, x.shape[-1])) for x in xs]
    else:
        norths, souths = out
    for s in range(1, n):
        norths[s].copy_(xs[s - 1][..., -h:, :])
        souths[s - 1].copy_(xs[s][..., :h, :])
    return norths, souths


def psum(vals: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum over a row's shards, summed in shard order on shard 0's
    device; every shard gets it on its own device (one tensor shared by the
    shards of one device)."""
    tot = vals[0]
    for v in vals[1:]:
        tot = tot + v.to(vals[0].device)
    return _replicate(tot, [v.device for v in vals])


def all_gather(xs: Sequence[torch.Tensor], dim: int = -2) -> List[torch.Tensor]:
    """The row's shards joined along ``dim``; every shard gets the whole on
    its own device (shared by the shards of one device)."""
    dev0 = xs[0].device
    whole = torch.cat([x.to(dev0) for x in xs], dim=dim)
    return _replicate(whole, [x.device for x in xs])


def _replicate(t: torch.Tensor, devices) -> List[torch.Tensor]:
    copies = {t.device: t}
    out = []
    for d in devices:
        if d not in copies:
            copies[d] = t.to(d)
        out.append(copies[d])
    return out


# ------------------------------------------------- placing global arrays

def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} ({n}) must divide into {parts} shards")
    return n // parts


def shard_batch(mesh: Mesh, a: torch.Tensor):
    """A ``(B, ...)`` array split over ``dp`` (batch) and replicated over
    ``sp``: ``out[d][s]`` is ``a[d*B/dp:(d+1)*B/dp]`` on shard ``(d, s)``'s
    device."""
    bl = _split(a.shape[0], mesh.dp, "batch")
    out = []
    for d in range(mesh.dp):
        part = a[d * bl:(d + 1) * bl].contiguous()
        out.append(_replicate(part, mesh.row(d)))
    return out


def shard_rows(mesh: Mesh, a: torch.Tensor, row_dim: int = -2):
    """A ``(B, ..., ny, ...)`` array split over ``dp`` (batch, dim 0) and
    ``sp`` (the rows, ``row_dim``): ``out[d][s]`` is a contiguous copy of
    the block of shard ``(d, s)`` on its device."""
    bl = _split(a.shape[0], mesh.dp, "batch")
    nyl = _split(a.shape[row_dim], mesh.sp, "rows")
    out = []
    for d in range(mesh.dp):
        part = a[d * bl:(d + 1) * bl]
        row = []
        for s, dev in enumerate(mesh.row(d)):
            blk = part.narrow(row_dim, s * nyl, nyl)
            row.append(blk.to(dev, copy=True).contiguous())
        out.append(row)
    return out


def gather_rows(xs, device, row_dim: int = -2) -> torch.Tensor:
    """Inverse of :func:`shard_rows`: the global array on ``device``."""
    return torch.cat([torch.cat([x.to(device) for x in row], dim=row_dim)
                      for row in xs], dim=0)
