"""Domain-decomposed matrix-free Wilson--Dirac hopping operator on
canonical lattice-shaped fields, in plain PyTorch.

Counterpart of ``mgpgcr_tpu/parallel/wilson.py``: the stencil of
``ops/wilson.py::WilsonDiracOperator`` on one rank's shard, its 8
neighbour accesses local rolls plus one-plane halo exchanges
(``parallel/halo.py``), every exchange issued before any contraction. It
is the layout-independent oracle of the sharded operator: the ghost-plane
Dslash (``kernels/dslash_dist.py``) is held against the same numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.wilson import P_MINUS, P_PLUS
from mgpgcr_tpu_torch.parallel.halo import periodic_shift
from mgpgcr_tpu_torch.parallel.mesh import cut_shard


def spacetime_axis_names(grid, mesh: LatticeMesh, batch_axis: str | None = None) -> tuple:
    """Grid axes in order, ``batch_axis`` left out, onto lattice dims 0, 1,
    ...: one entry (a name or None) per spacetime dim."""
    names = tuple(n for n in grid.axis_names if n != batch_axis)
    return tuple(names[i] if i < len(names) else None for i in range(mesh.n_spacetime))


def shard_lattice_field(x, grid, rank: int, mesh: LatticeMesh, batch_axis: str | None = None):
    """This rank's block of a lattice-shaped (..., T, Z, Y, X, 4, 3) field;
    with ``batch_axis``, of a stack (B, T, Z, Y, X, 4, 3) whose B right-hand
    sides are split over that grid axis too."""
    names = spacetime_axis_names(grid, mesh, batch_axis)
    nd = len(mesh.dims)
    dims = {n: mu - nd for mu, n in enumerate(names)}
    if batch_axis is not None:
        dims[batch_axis] = -nd - 1
    return cut_shard(x, grid, rank, dims)


@dataclasses.dataclass(frozen=True)
class ShardedWilsonDirac(LinearOperator):
    """D psi on this rank's shard of a lattice split over the grid's axes
    (the first splits t, the second z, ...). ``apply`` takes and returns
    this rank's (..., T_l, Z_l, Y_l, X_l, 4, 3) complex block; every rank
    must call it together."""

    links: torch.Tensor  # this rank's (4, T_l, Z_l, Y_l, X_l, 3, 3) complex links
    mesh: LatticeMesh  # the global lattice
    comm: object
    axis_names: tuple  # per spacetime dim: grid axis name or None

    @staticmethod
    def build(links, mesh: LatticeMesh, comm, batch_axis: str | None = None
              ) -> "ShardedWilsonDirac":
        """``links``: global canonical (4, T, Z, Y, X, 3, 3) complex links
        (ndarray or tensor). ``batch_axis`` names a grid axis that splits
        stacked right-hand sides instead of the lattice (the JAX package's
        data-parallel axis): its ranks hold the same links."""
        names = spacetime_axis_names(comm.grid, mesh, batch_axis)
        local = cut_shard(torch.as_tensor(links), comm.grid, comm.rank,
                          {n: 1 + mu for mu, n in enumerate(names)})
        return ShardedWilsonDirac(local.to(comm.device), mesh, comm, names)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.mesh.size, self.mesh.size)

    @property
    def device(self) -> torch.device:
        return self.links.device

    def apply(self, psi: torch.Tensor) -> torch.Tensor:
        """All halo exchanges of the 8 hops first, then the colour and spin
        contractions, as the JAX package orders them."""
        u_all = self.links.to(psi.dtype)
        shifts = []
        for mu in range(4):
            name = self.axis_names[mu]
            axis = psi.ndim - 6 + mu
            u = u_all[mu]
            udag = u.conj().transpose(-1, -2)
            shifts.append((
                u,
                periodic_shift(psi, axis, -1, self.comm, name),
                periodic_shift(udag, mu, 1, self.comm, name),
                periodic_shift(psi, axis, 1, self.comm, name),
            ))
        out = torch.zeros_like(psi)
        for mu, (u, fwd, udag, bwd) in enumerate(shifts):
            pm = torch.as_tensor(P_MINUS[mu], dtype=psi.dtype, device=psi.device)
            pp = torch.as_tensor(P_PLUS[mu], dtype=psi.dtype, device=psi.device)
            # forward: (1 - gamma_mu) U_mu(x) psi(x + mu)
            fwd = torch.einsum("tzyxab,...tzyxsb->...tzyxsa", u, fwd)
            out = out + torch.einsum("st,...tc->...sc", pm, fwd)
            # backward: (1 + gamma_mu) U_mu^dag(x - mu) psi(x - mu)
            bwd = torch.einsum("tzyxab,...tzyxsb->...tzyxsa", udag, bwd)
            out = out + torch.einsum("st,...tc->...sc", pp, bwd)
        return out
