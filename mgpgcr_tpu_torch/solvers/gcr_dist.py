"""Domain-decomposed GCR: one rank's solve on its shard, and a
single-process entry point that runs every rank of a grid as a thread.

Counterpart of ``mgpgcr_tpu/solvers/gcr_dist.py``. The JAX package runs
the whole ``gcr_solve`` inside one ``shard_map``: per-shard kernels, scalar
reductions ``psum``med over the mesh axes. Here ``gcr_solve_sharded`` is
that per-shard body (``local_solve``): ``gcr_solve`` on this rank's shard
with its communicator, so every reduction is summed over ranks and every
rank takes the same branch of the loop. Unpreconditioned fused solves run
their iterations through the ghost-plane one-pass step (B15), the
operator's applies through the ghost-plane Dslash (B14), and the other
fused kernels unchanged on the shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mgpgcr_tpu_torch.ops.dirac import DiracOperator
from mgpgcr_tpu_torch.ops.dslash_dist import ShardLocalWilsonDirac
from mgpgcr_tpu_torch.parallel.comm import DEFAULT_TIMEOUT, run_spmd
from mgpgcr_tpu_torch.parallel.mesh import ShardGrid, gather_field, shard_field
from mgpgcr_tpu_torch.solvers.gcr import gcr_solve
from mgpgcr_tpu_torch.solvers.params import GCRParams
from mgpgcr_tpu_torch.solvers.result import SolveResult


def gcr_solve_sharded(a_local, rhs_local, params: GCRParams, comm, precond=None, x0=None,
                      fused: Optional[bool] = None) -> SolveResult:
    """This rank's part of the domain-decomposed GCR solve of A x = rhs.

    ``a_local`` is a ``DiracOperator`` over a ``ShardLocalWilsonDirac`` (or
    the bare operator); ``rhs_local`` and ``x0`` are this rank's slabs
    (``parallel/mesh.py::shard_field``); ``precond``, when given, must be
    right on local shards with its own reductions summed over ``comm``.
    Every rank must call this together. Returns this rank's slab of x;
    the scalars and the history are the global ones, equal on every
    rank."""
    d = a_local.d if isinstance(a_local, DiracOperator) else a_local
    if not isinstance(d, ShardLocalWilsonDirac):
        raise ValueError("gcr_solve_sharded wants a ShardLocalWilsonDirac (or A = I - kD over one)")
    if d.comm is not comm:
        raise ValueError("the operator was built for another communicator")
    return gcr_solve(a_local, rhs_local, params, precond=precond, x0=x0, fused=fused, comm=comm)


def gcr_solve_grid(links_canonical, mesh, k, rhs, params: GCRParams, grid: ShardGrid,
                   axis_t="t", axis_z=None, compress: bool = False, antiperiodic_t: bool = False,
                   link_dtype=torch.float32, x0=None, fused: Optional[bool] = None,
                   timeout: float = DEFAULT_TIMEOUT) -> SolveResult:
    """The domain-decomposed solve of (I - kD) x = rhs on one process: the
    global right-hand side (and ``x0``), fields (4, 3, T, Z, Y*X), is cut
    over ``grid``, every rank runs :func:`gcr_solve_sharded` as a thread
    (``run_spmd``) on its device, and the result's ``x`` is the gathered
    global solution; its scalars are rank 0's, which every rank shares.
    ``links_canonical`` is as ``ShardLocalWilsonDirac.build`` takes it."""

    def rank_solve(comm):
        d = ShardLocalWilsonDirac.build(links_canonical, mesh, comm, axis_t, axis_z, compress,
                                        antiperiodic_t, link_dtype)
        b = shard_field(rhs, grid, comm.rank, axis_t, axis_z).to(comm.device)
        x_loc = None if x0 is None else shard_field(x0, grid, comm.rank, axis_t, axis_z).to(
            comm.device)
        return gcr_solve_sharded(DiracOperator(d, k), b, params, comm, x0=x_loc, fused=fused)

    results = run_spmd(grid, rank_solve, timeout=timeout)
    x = gather_field([res.x for res in results], grid, axis_t, axis_z)
    return dataclasses.replace(results[0], x=x)
