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
           "all_gather", "shard_rows", "shard_batch", "gather_rows",
           "ShardedField"]


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

def halo_strips(xs: Sequence[torch.Tensor], h: int, out=None, dim: int = -2):
    """``(norths, souths)`` of a row of shards ``(..., ny_l, nx)``: shard
    ``s`` receives shard ``s-1``'s last ``h`` rows as its north strip and
    shard ``s+1``'s first ``h`` rows as its south strip; the strips beyond
    the global top and bottom are zeros.  ``out = (norths, souths)`` reuses
    strip buffers (their edge entries must hold zeros).  ``dim``: the split
    axis (-3 for z-slabs of volumes)."""
    n = len(xs)
    if out is None:
        def strip(x):
            shape = list(x.shape)
            shape[dim] = h
            return x.new_zeros(shape)
        norths = [strip(x) for x in xs]
        souths = [strip(x) for x in xs]
    else:
        norths, souths = out
    for s in range(1, n):
        up = xs[s - 1]
        norths[s].copy_(up.narrow(dim, up.shape[dim] - h, h))
        souths[s - 1].copy_(xs[s].narrow(dim, 0, h))
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


# ------------------------------------------------- a field over the mesh

class ShardedField:
    """A field split over a mesh as the drivers see it: ``shards[d][s]``,
    the tensors ``(B_l, ...)`` of dp row ``d``, shard ``s``, with the global
    shape, dtype and result device.

    It carries the algebra ``solvers.pcg.run_pcg`` applies to a field, shard
    by shard: ``+``, ``-`` and ``*`` with a field of the same layout, ``*``
    with a per-image tensor ``(B, 1, ...)`` (dp row ``d`` takes images
    ``[d B_l, (d + 1) B_l)``) or a 0-dim one, and ``torch.where(cond, a,
    b)`` with such a ``cond``.  So one ``run_pcg`` loop drives every shard,
    its per-image scalars on the result device."""

    def __init__(self, shards, shape, dtype, device):
        self.shards = shards
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = device

    def dim(self) -> int:
        return len(self.shape)

    def like(self, shards) -> "ShardedField":
        return ShardedField(shards, self.shape, self.dtype, self.device)

    def part(self, v: torch.Tensor, d: int, dev) -> torch.Tensor:
        """Dp row ``d``'s part of a per-image or 0-dim tensor ``v``, on
        ``dev``."""
        if v.dim():
            bl = self.shards[d][0].shape[0]
            v = v[d * bl:(d + 1) * bl]
        return v.to(dev)

    def _zip(self, fn, other):
        if isinstance(other, ShardedField):
            return self.like([[fn(a, b) for a, b in zip(ra, rb)]
                              for ra, rb in zip(self.shards, other.shards)])
        return self.like([[fn(a, self.part(other, d, a.device)) for a in row]
                          for d, row in enumerate(self.shards)])

    def __add__(self, other):
        return self._zip(torch.add, other)

    def __sub__(self, other):
        return self._zip(torch.sub, other)

    def __mul__(self, other):
        return self._zip(torch.mul, other)

    __rmul__ = __mul__

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is not torch.where or kwargs:
            return NotImplemented
        cond, a, b = args
        return a.like([[torch.where(a.part(cond, d, x.device), x, y)
                        for x, y in zip(ra, rb)]
                       for d, (ra, rb) in enumerate(zip(a.shards, b.shards))])
