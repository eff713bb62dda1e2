"""Lattice geometry: the static description of a lattice index space and
its 4-D blocking.

Counterpart of ``LatticeMesh`` and ``BlockMap`` in ``mgpgcr_tpu/mesh.py``.
Conventions are the reference's: a field index is ``(t, z, y, x, spinor,
colour)`` with a row-major linear offset, colour fastest
(Mesh.h:369-398); blocks are numbered row-major over the 4 block
coordinates (Mesh.h:168-233).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LatticeMesh:
    """``dims`` is the full index extent, e.g. ``(8, 8, 8, 8, 4, 3)``; the
    first ``n_spacetime`` dims are spacetime, the rest site-internal."""

    dims: tuple[int, ...]
    n_spacetime: int = 4

    def __post_init__(self):
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        if self.n_spacetime > len(self.dims):
            raise ValueError("n_spacetime exceeds number of dims")

    @property
    def size(self) -> int:
        """Total number of complex degrees of freedom (Mesh.h:50)."""
        return math.prod(self.dims)

    @property
    def spacetime_dims(self) -> tuple[int, ...]:
        return self.dims[: self.n_spacetime]

    @property
    def internal_dims(self) -> tuple[int, ...]:
        return self.dims[self.n_spacetime :]

    @property
    def n_sites(self) -> int:
        return math.prod(self.spacetime_dims)

    @property
    def site_dof(self) -> int:
        """Degrees of freedom per site (4 spinor x 3 colour = 12)."""
        return math.prod(self.internal_dims)

    def to_lattice(self, x):
        """Reshape (..., size) -> (..., *dims)."""
        return x.reshape(tuple(x.shape[:-1]) + self.dims)

    def to_flat(self, x):
        """Reshape (..., *dims) -> (..., size)."""
        lead = tuple(x.shape[: x.ndim - len(self.dims)])
        return x.reshape(lead + (self.size,))

    def coords_to_index(self, coords) -> int:
        """Row-major linearisation (Mesh::ind_loc, Mesh.h:146-154)."""
        idx = 0
        for c, d in zip(coords, self.dims):
            idx = idx * d + int(c)
        return idx

    def index_to_coords(self, index: int) -> tuple[int, ...]:
        """Inverse of :meth:`coords_to_index` (Mesh::alloc_loc_ind, Mesh.h:157-165)."""
        coords = []
        for d in reversed(self.dims):
            coords.append(index % d)
            index //= d
        return tuple(reversed(coords))

    def blocking(self, block) -> "BlockMap":
        """4-D spacetime blocking (Mesh::blocking, Mesh.h:237-298); ``block``
        is one extent for every spacetime dim or a per-dim tuple."""
        if isinstance(block, int):
            block = (block,) * self.n_spacetime
        block = tuple(int(b) for b in block)
        if len(block) != self.n_spacetime:
            raise ValueError("block extent must have one entry per spacetime dim")
        for d, b in zip(self.spacetime_dims, block):
            if d % b != 0:
                raise ValueError(f"block extent {b} does not divide lattice dim {d}")
        return BlockMap(mesh=self, block_dims=block)


@dataclass(frozen=True)
class BlockMap:
    """A 4-D domain decomposition as layout transforms: a canonical flat
    field ``(..., N)`` (``to_blocked``) or a slab field ``(..., 4, 3, T, Z,
    Y*X)`` (``to_blocked_tpu``) becomes a blocked field ``(..., n_blocks,
    block_len)``, block_len = block volume x site dof, with the within-block
    dof order (spacetime, then internal) row-major; both layouts give the
    same blocked form. A tensor or a ``cplx.CF``."""

    mesh: LatticeMesh
    block_dims: tuple[int, ...]

    @property
    def blocks_per_dim(self) -> tuple[int, ...]:
        return tuple(d // b for d, b in zip(self.mesh.spacetime_dims, self.block_dims))

    @property
    def n_blocks(self) -> int:
        return math.prod(self.blocks_per_dim)

    @property
    def block_sites(self) -> int:
        return math.prod(self.block_dims)

    @property
    def block_len(self) -> int:
        """Complex dof per block = block volume x (spinor x colour)."""
        return self.block_sites * self.mesh.site_dof

    def _split_shape(self) -> tuple[int, ...]:
        """(Bt, bt, Bz, bz, ..., *internal)."""
        shape = ()
        for d, b in zip(self.mesh.spacetime_dims, self.block_dims):
            shape += (d // b, b)
        return shape + self.mesh.internal_dims

    def _block_axes_perm(self) -> tuple[int, ...]:
        """Block coordinates first, then within-block ones, then internal."""
        ns, n_int = self.mesh.n_spacetime, len(self.mesh.internal_dims)
        return (tuple(range(0, 2 * ns, 2)) + tuple(range(1, 2 * ns, 2))
                + tuple(range(2 * ns, 2 * ns + n_int)))

    def to_blocked(self, x):
        """Canonical flat (..., N) -> (..., n_blocks, block_len), blocks
        row-major over the block coordinates (Mesh.h:168-233)."""
        lead = tuple(x.shape[:-1])
        nl = len(lead)
        split = x.reshape(lead + self._split_shape())
        moved = split.permute(tuple(range(nl)) + tuple(nl + a for a in self._block_axes_perm()))
        return moved.reshape(lead + (self.n_blocks, self.block_len))

    def from_blocked(self, xb):
        """(..., n_blocks, block_len) -> canonical flat (..., N); inverse of
        :meth:`to_blocked`."""
        lead = tuple(xb.shape[:-2])
        nl = len(lead)
        mid = xb.reshape(lead + self.blocks_per_dim + self.block_dims + self.mesh.internal_dims)
        fwd = self._block_axes_perm()
        inv = [0] * len(fwd)
        for i, p in enumerate(fwd):
            inv[p] = i
        moved = mid.permute(tuple(range(nl)) + tuple(nl + a for a in inv))
        return moved.reshape(lead + (self.mesh.size,))

    def to_blocked_tpu(self, x):
        """(..., 4, 3, T, Z, Y*X) -> (..., n_blocks, block_len); a tensor or
        a ``cplx.CF``."""
        t, z, y, xx = self.mesh.spacetime_dims
        bt, bz, by, bx = self.block_dims
        lead = tuple(x.shape[: x.ndim - 5])
        nl = len(lead)
        split = x.reshape(lead + (4, 3, t // bt, bt, z // bz, bz, y // by, by, xx // bx, bx))
        perm = tuple(range(nl)) + tuple(nl + a for a in (2, 4, 6, 8, 3, 5, 7, 9, 0, 1))
        return split.permute(perm).reshape(lead + (self.n_blocks, self.block_len))

    def from_blocked_tpu(self, xb):
        """(..., n_blocks, block_len) -> (..., 4, 3, T, Z, Y*X)."""
        t, z, y, xx = self.mesh.spacetime_dims
        bt, bz, by, bx = self.block_dims
        lead = tuple(xb.shape[:-2])
        nl = len(lead)
        mid = xb.reshape(lead + (t // bt, z // bz, y // by, xx // bx, bt, bz, by, bx, 4, 3))
        inv = (8, 9, 0, 4, 1, 5, 2, 6, 3, 7)  # inverse of to_blocked_tpu's permutation
        moved = mid.permute(tuple(range(nl)) + tuple(nl + a for a in inv))
        return moved.reshape(lead + (4, 3, t, z, y * xx))

    def site_blocks(self) -> np.ndarray:
        """(T, Z, Y*X) int64: the block index of every site."""
        t, z, y, xx = self.mesh.spacetime_dims
        nbt, nbz, nby, nbx = self.blocks_per_dim
        bt, bz, by, bx = self.block_dims
        ct, cz, cy, cx = np.meshgrid(
            np.arange(t) // bt, np.arange(z) // bz, np.arange(y) // by, np.arange(xx) // bx,
            indexing="ij",
        )
        return (((ct * nbz + cz) * nby + cy) * nbx + cx).reshape(t, z, y * xx)

    def neighbor_table(self) -> np.ndarray:
        """(n_blocks, 9) int32: [self, +d0, -d0, +d1, -d1, ...] with periodic
        wrap, the coarse 9-point stencil of the Galerkin assembly
        (MG.h:229-276)."""
        bpd = self.blocks_per_dim
        coords = np.stack(np.unravel_index(np.arange(self.n_blocks), bpd), axis=1)
        cols = [np.arange(self.n_blocks)]
        for d in range(len(bpd)):
            for sgn in (1, -1):
                nbc = coords.copy()
                nbc[:, d] = (nbc[:, d] + sgn) % bpd[d]
                cols.append(np.ravel_multi_index(tuple(nbc.T), bpd))
        return np.stack(cols, axis=1).astype(np.int32)
