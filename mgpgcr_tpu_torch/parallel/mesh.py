"""The grid of shards a lattice is split over, and the cutting of global
fields and links into this rank's slab.

Counterpart of ``mgpgcr_tpu/parallel/mesh.py``. Where the JAX package lays
a lattice over a ``jax.sharding.Mesh`` of devices, the port names a
``ShardGrid``: named axes, their sizes and one device for each rank, the
ranks numbered row-major over the axes (as ``dev_array.reshape(axis_sizes)``
numbers the JAX mesh). A spacetime axis of the lattice is split over a named
axis of the grid; every other index stays rank-local. Several ranks may
share one device (``run_spmd`` runs them as threads of one process).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx


def balanced_factors(n: int, k: int) -> tuple[int, ...]:
    """Factor ``n`` into ``k`` integers, largest first, as balanced as the
    prime factorisation allows (e.g. 8, 3 -> (2, 2, 2); 12, 2 -> (4, 3))."""
    factors: list[int] = []
    m = n
    d = 2
    while d * d <= m:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1
    if m > 1:
        factors.append(m)
    out = [1] * k
    # greedily multiply primes (largest first) onto the currently-smallest bin
    for f in sorted(factors, reverse=True):
        out[int(np.argmin(out))] *= f
    return tuple(sorted(out, reverse=True))


@dataclasses.dataclass(frozen=True)
class ShardGrid:
    """Named axes of ranks, numbered row-major, and each rank's device."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]  # one per rank

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, rank: int) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(rank, self.axis_sizes))

    def rank_of(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.axis_sizes))

    def axis_size(self, name: str | None) -> int:
        """Ranks along the named axis; 1 for None (an unsplit lattice axis)."""
        return 1 if name is None else self.axis_sizes[self.axis_names.index(name)]


def rank_device(device=None) -> torch.device:
    """A rank's device, CUDA unless named, with a card index (the current
    card for a bare "cuda"), so that a rank's thread can make it current."""
    dev = cplx.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_shard_grid(axis_sizes, axis_names=("t", "z"), device=None) -> ShardGrid:
    """A grid of ``axis_sizes`` ranks (or of an int n, split by
    :func:`balanced_factors`) over ``axis_names``. ``device`` is one device
    for every rank, or a list with one per rank; CUDA unless named
    (counterpart of ``make_lattice_device_mesh``)."""
    if isinstance(axis_sizes, int):
        axis_sizes = balanced_factors(axis_sizes, len(axis_names))
    sizes = tuple(int(s) for s in axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"axis sizes {sizes} do not match axis names {tuple(axis_names)}")
    n = math.prod(sizes)
    if isinstance(device, (list, tuple)):
        devices = tuple(rank_device(d) for d in device)
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
    else:
        devices = (rank_device(device),) * n
    return ShardGrid(tuple(axis_names), sizes, devices)


def _narrow(x, dim: int, start: int, length: int):
    if cplx.is_cf(x):
        return cplx.CF(x.re.narrow(dim, start, length), x.im.narrow(dim, start, length))
    return x.narrow(dim, start, length)


def _cat(parts, dim: int):
    if cplx.is_cf(parts[0]):
        return cplx.concatenate(parts, axis=dim % parts[0].ndim)
    return torch.cat(parts, dim=dim)


def cut_shard(x, grid: ShardGrid, rank: int, dims: dict):
    """This rank's block of ``x`` (a tensor or CF): array dim ``dims[name]``
    is split evenly over grid axis ``name``; None names are skipped.
    Returns a contiguous copy or view."""
    coords = grid.coords(rank)
    for name, dim in dims.items():
        if name is None:
            continue
        i = grid.axis_names.index(name)
        n = grid.axis_sizes[i]
        extent = x.shape[dim]
        if extent % n:
            raise ValueError(f"extent {extent} of dim {dim} does not split over {n} ranks")
        w = extent // n
        x = _narrow(x, dim, coords[i] * w, w)
    return x.contiguous()


def join_shards(shards, grid: ShardGrid, dims: dict):
    """Inverse of :func:`cut_shard`: the ranks' blocks (a list indexed by
    rank) joined along ``dims``; grid axes not named in ``dims`` hold
    copies, of which the first is taken."""
    axis_dim = {grid.axis_names.index(n): d for n, d in dims.items() if n is not None}

    def rec(prefix):
        i = len(prefix)
        if i == len(grid.axis_sizes):
            return shards[grid.rank_of(prefix)]
        if i not in axis_dim:
            return rec(prefix + (0,))
        return _cat([rec(prefix + (c,)) for c in range(grid.axis_sizes[i])], axis_dim[i])

    return rec(())


def shard_field(x, grid: ShardGrid, rank: int, axis_t="t", axis_z=None):
    """This rank's slab of a (..., 4, 3, T, Z, Y*X) field."""
    return cut_shard(x, grid, rank, {axis_t: -3, axis_z: -2})


def shard_links(links, grid: ShardGrid, rank: int, axis_t="t", axis_z=None):
    """This rank's slab of t-major (T, 4, R, 3, Z, Y*X) links."""
    return cut_shard(links, grid, rank, {axis_t: 0, axis_z: 4})


def gather_field(shards, grid: ShardGrid, axis_t="t", axis_z=None):
    """The global (..., 4, 3, T, Z, Y*X) field from the ranks' slabs."""
    return join_shards(shards, grid, {axis_t: -3, axis_z: -2})
