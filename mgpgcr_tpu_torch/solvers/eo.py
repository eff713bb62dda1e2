"""Even-odd (Schur-complement) solve of A = I - k D.

Counterpart of ``mgpgcr_tpu/solvers/eo.py`` (single device; the sharded
``eo_sharded`` is not ported yet). The full Wilson--Dirac solve reduces to
the half-dimension even-site system S x_e = b_e + k D_eo b_o with
S = I - k^2 D_eo D_oe, then x_o = b_o + k D_oe x_e (``ops/eo.py``); the
reconstructed x solves the full system to the Schur solve's tolerance.
The Schur system is a generic operator to ``gcr_solve``: with
``fused=True`` it runs the fused cycles' algebra kernels on half-size
fields, and ``setup_eo_mg`` runs the transfer kernels on the half mesh.
"""

from __future__ import annotations

import dataclasses

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.eo import EvenOddWilson, field_from_eo, field_to_eo, make_schur
from mgpgcr_tpu_torch.solvers.gcr import Preconditioner, gcr_solve
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams
from mgpgcr_tpu_torch.solvers.result import SolveResult


def eo_solve(eo: EvenOddWilson, k, rhs: cplx.CF, params: GCRParams,
             precond: Preconditioner | None = None, mesh: LatticeMesh | None = None
             ) -> SolveResult:
    """Solve (I - k D) x = rhs through the even-site Schur complement.

    ``rhs`` is a full-lattice slab field (4, 3, T, Z, Y*X) and the result's
    ``x`` is full-lattice again; the history and iteration count are the
    Schur solve's. ``precond`` (optional) preconditions the Schur system."""
    mesh = mesh if mesh is not None else eo.mesh
    s = make_schur(eo, k, rhs.dtype)
    b_e, b_o = field_to_eo(rhs, mesh)
    rhs_e = b_e + eo.apply_eo(b_o) * s.k
    res = gcr_solve(s, rhs_e.contiguous(), params, precond=precond)
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
