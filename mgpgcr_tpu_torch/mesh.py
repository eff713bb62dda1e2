"""Lattice geometry: the static description of a lattice index space.

Counterpart of ``LatticeMesh`` in ``mgpgcr_tpu/mesh.py``. Conventions are
the reference's: a field index is ``(t, z, y, x, spinor, colour)`` with a
row-major linear offset, colour fastest (Mesh.h:369-398).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


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
    def n_sites(self) -> int:
        return math.prod(self.spacetime_dims)

    def to_lattice(self, x):
        """Reshape (..., size) -> (..., *dims)."""
        return x.reshape(tuple(x.shape[:-1]) + self.dims)

    def to_flat(self, x):
        """Reshape (..., *dims) -> (..., size)."""
        lead = tuple(x.shape[: x.ndim - len(self.dims)])
        return x.reshape(lead + (self.size,))
