"""Even-odd (Schur-complement) solve of A = I - k D.

Counterpart of ``mgpgcr_tpu/solvers/eo.py``. The full Wilson--Dirac solve reduces to
the half-dimension even-site system S x_e = b_e + k D_eo b_o with
S = I - k^2 D_eo D_oe, then x_o = b_o + k D_oe x_e (``ops/eo.py``); the
reconstructed x solves the full system to the Schur solve's tolerance.
The Schur system is a generic operator to ``gcr_solve``: with
``fused=True`` it runs the fused cycles' algebra kernels on half-size
fields, and ``setup_eo_mg`` runs the transfer kernels on the half mesh.

Decomposed over (t, z) shards (``eo_sharded``): the JAX package places the
parity links under a ``NamedSharding`` and lets GSPMD insert the halo
exchanges; PyTorch has no partitioner, so here each rank holds a
shard-local ``EvenOddWilson`` whose t and z hops take their boundary
planes from the ring neighbours through the communicator, and the Schur
GCR sums its dots over the ranks.
"""

from __future__ import annotations

import dataclasses

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.eo import EvenOddWilson, field_from_eo, field_to_eo, make_schur
from mgpgcr_tpu_torch.parallel.comm import DEFAULT_TIMEOUT, run_spmd
from mgpgcr_tpu_torch.parallel.mesh import ShardGrid, cut_shard, gather_field, shard_field
from mgpgcr_tpu_torch.solvers.gcr import Preconditioner, gcr_solve
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams
from mgpgcr_tpu_torch.solvers.result import SolveResult


def eo_solve(eo: EvenOddWilson, k, rhs: cplx.CF, params: GCRParams,
             precond: Preconditioner | None = None, mesh: LatticeMesh | None = None
             ) -> SolveResult:
    """Solve (I - k D) x = rhs through the even-site Schur complement.

    ``rhs`` is a full-lattice slab field (4, 3, T, Z, Y*X) and the result's
    ``x`` is full-lattice again; the history and iteration count are the
    Schur solve's. ``precond`` (optional) preconditions the Schur system.
    With a shard-local ``eo`` (:func:`eo_sharded`) ``rhs`` and x are this
    rank's slabs, and every rank must call it together."""
    mesh = mesh if mesh is not None else eo.mesh
    s = make_schur(eo, k, rhs.dtype)
    b_e, b_o = field_to_eo(rhs, mesh)
    rhs_e = b_e + eo.apply_eo(b_o) * s.k
    res = gcr_solve(s, rhs_e.contiguous(), params, precond=precond, comm=eo.comm)
    x_o = b_o + eo.apply_oe(res.x) * s.k
    return dataclasses.replace(res, x=field_from_eo(res.x, x_o, mesh))


def eo_half_mesh(mesh: LatticeMesh) -> LatticeMesh:
    """The index space of the compact parity layout: spacetime (T, Z, Y,
    X/2) with the same internal dof."""
    t, z, y, xx = mesh.spacetime_dims
    return LatticeMesh((t, z, y, xx // 2, *mesh.internal_dims))


def eo_mg_params(params: MGParams) -> MGParams:
    """The MG parameters of the Schur system: ``params.block`` is the
    fine-lattice extent (its x extent must be even), halved in x onto the
    half mesh; the per-block-column Galerkin sweep and a dense coarse
    operator (see ``setup_eo_mg``)."""
    b = params.block
    bt, bz, by, bx = b if isinstance(b, tuple) else (b, b, b, b)
    if bx % 2:
        raise ValueError("even-odd MG needs an even x block extent")
    return dataclasses.replace(params, block=(bt, bz, by, max(bx // 2, 1)),
                               assembly="columns", coarse_format="dense")


def setup_eo_mg(generator, eo: EvenOddWilson, k, params: MGParams, smoother_operator=None,
                timings: dict | None = None):
    """Adaptive MG over the Schur complement S: ``setup_mg`` on S over the
    half mesh. Returns ``(schur_op, mg_preconditioner)``; pass the
    preconditioner's ``apply`` as ``eo_solve``'s ``precond``.

    gamma5-hermiticity survives the Schur reduction, so the chiral
    doubling applies on compact even fields; the fine block b^4 is exactly
    the half mesh's (b, b, b, b/2) block (the layout stores x = 2 xh + o),
    so aggregation stays a reshape. S hops two sites, so its coarse
    coupling reaches diagonal neighbour blocks: the setup forces the
    per-block-column Galerkin sweep (``assembly="columns"``) and a dense
    coarse operator, as the JAX package does (``eo_mg_params``). The JAX
    package also forces its XLA transfers; the port keeps
    ``params.transfer_backend`` ("auto": the transfer kernels on CUDA
    tensors, at the half mesh's rows of Y*X/2 sites)."""
    from mgpgcr_tpu_torch.solvers.mg import setup_mg

    s = make_schur(eo, k, eo.dtype)
    mgp = setup_mg(generator, s, eo_half_mesh(eo.mesh), eo_mg_params(params),
                   smoother_operator=smoother_operator, timings=timings)
    return s, mgp


def eo_sharded(eo: EvenOddWilson, comm, axis_t: str | None = "t",
               axis_z: str | None = "z") -> EvenOddWilson:
    """This rank's shard-local ``EvenOddWilson`` of the lattice split over
    grid axes ``axis_t`` and ``axis_z`` (None: not split): the parity links
    cut to the rank's (t, z) slab and moved to its device, the t and z hops
    exchanging their boundary planes through ``comm``.

    The compact parity layout indexes a site by its offset (t + z + y + p)
    mod 2 within the shard, which is the global one only where the shard
    starts at an even t and z: the local T and Z extents must be even."""
    t, z, y, xx = eo.mesh.spacetime_dims
    nt, nz = comm.axis_size(axis_t), comm.axis_size(axis_z)
    if t % nt or z % nz:
        raise ValueError(f"lattice (T={t}, Z={z}) does not tile the grid ({nt} x {nz})")
    tl, zl = t // nt, z // nz
    if tl % 2 or zl % 2:
        raise ValueError(
            f"even-odd on shards needs even local T and Z extents, got ({tl}, {zl}): the "
            "parity of a shard's sites must be the global one"
        )
    dims = {axis_t: 3, axis_z: 4}  # the links' (4, 3, 3, T, Z, V/2) axes

    def cut(links):
        return cut_shard(links, comm.grid, comm.rank, dims).to(comm.device)

    local = LatticeMesh((tl, zl, y, xx, *eo.mesh.internal_dims))
    return EvenOddWilson(cut(eo.links_e), cut(eo.links_o), local, comm, axis_t, axis_z)


def eo_field_sharding(comm, axis_t: str | None = "t", axis_z: str | None = "z"):
    """The cut of a field over the grid of ``comm``: a function from a
    global field, full (4, 3, T, Z, Y*X) or compact parity (4, 3, T, Z,
    V/2), to this rank's slab on its device (the JAX package's
    ``NamedSharding`` of parity fields)."""

    def cut(x):
        return shard_field(x, comm.grid, comm.rank, axis_t, axis_z).to(comm.device)

    return cut


def eo_solve_grid(eo: EvenOddWilson, k, rhs: cplx.CF, params: GCRParams, grid: ShardGrid,
                  axis_t: str | None = "t", axis_z: str | None = "z",
                  timeout: float = DEFAULT_TIMEOUT) -> SolveResult:
    """The even-odd solve decomposed over ``grid`` in one process: every rank
    runs as a thread (``run_spmd``), holds its :func:`eo_sharded` shard and
    runs :func:`eo_solve` on its slab of the global ``rhs``; the result's x
    is the gathered global solution, its scalars rank 0's, which every rank
    shares."""

    def rank_solve(comm):
        local = eo_sharded(eo, comm, axis_t, axis_z)
        return eo_solve(local, k, eo_field_sharding(comm, axis_t, axis_z)(rhs), params)

    results = run_spmd(grid, rank_solve, timeout=timeout)
    x = gather_field([res.x for res in results], grid, axis_t, axis_z)
    return dataclasses.replace(results[0], x=x)
