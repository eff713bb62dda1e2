"""Sharded MG setup and the distributed MG-preconditioned GCR.

Counterpart of ``mgpgcr_tpu/solvers/mg_dist.py``. The JAX package runs
every phase of the adaptive-MG setup (the reference's ``MG::initialise``,
MG.h:132-285) on local lattice shards inside ``shard_map``; here each phase
is one rank's body over the port's communicator (``parallel/comm.py``), as
``solvers/gcr_dist.py::gcr_solve_sharded`` is:

- **near-null vectors** (MG.h:139-143): ``inverse_power_vectors`` with the
  communicator, every GCR solve in it the per-shard fused solve (the
  ghost-plane one-pass step B15, the ghost-plane Dslash B14) with its dots
  summed over ranks;
- **chiral doubling and per-block orthonormalisation** (MG.h:146-198):
  MG blocks never straddle shard edges (the block extent must divide the
  shard), so both are shard-local;
- **Galerkin assembly**: the phase-probed assembly of ``solvers/mg.py``
  with the probe phases at GLOBAL block coordinates (the shard's offset
  from ``comm.axis_index``); each probe's operator apply exchanges its own
  ghost planes, and the transfers are the kernels B10/B11 on the shard's
  field-shaped basis.

The coarse level: ``coarse_format="stencil"`` keeps each rank's stencil
rows (``ShardLocalCoarseStencil``, plain PyTorch as the JAX form is XLA;
its block planes cross ranks through the communicator) and solves the
coarse system distributed, its dots summed over ranks. Other formats
gather the blocks to every rank (``Comm.all_gather``) and solve the coarse
system replicated: each rank gathers the restricted residual, solves, and
keeps its own rows. Levels below the second are replicated and set up by
the single-device ``setup_mg`` machinery.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import transfer
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.dirac import DiracOperator
from mgpgcr_tpu_torch.ops.dslash_dist import ShardLocalWilsonDirac
from mgpgcr_tpu_torch.parallel.comm import run_spmd
from mgpgcr_tpu_torch.parallel.mesh import (
    ShardGrid, cut_shard, gather_field, join_shards, shard_field,
)
from mgpgcr_tpu_torch.solvers.gcr import gcr_solve
from mgpgcr_tpu_torch.solvers.mg import (
    _STORAGE,
    _check_params,
    _check_transfer_backend,
    _setup_level,
    block_orthonormalize,
    build_coarse_operator,
    chiral_double,
    coarse_gamma5_fn,
    field_basis,
    galerkin_coarse_blocks,
)
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams
from mgpgcr_tpu_torch.solvers.power import inverse_power_vectors
from mgpgcr_tpu_torch.solvers.result import SolveResult


def _unwrap(a):
    """(d, k) from a DiracOperator-wrapped or bare ShardLocalWilsonDirac."""
    d, k = (a.d, a.k) if isinstance(a, DiracOperator) else (a, None)
    if not isinstance(d, ShardLocalWilsonDirac):
        raise ValueError("sharded MG wants a ShardLocalWilsonDirac (or A = I - kD over one)")
    return d, k


@dataclasses.dataclass(frozen=True)
class ShardGeom:
    """The shard and block geometry of one rank, shared by setup and apply
    (the JAX package's ``_Geom``)."""

    mesh: LatticeMesh  # global
    local_mesh: LatticeMesh
    block: tuple[int, ...]
    bpd: tuple[int, ...]  # global blocks per dim (Bt, Bz, By, Bx)
    bpd_loc: tuple[int, ...]
    axis_t: str | None
    axis_z: str | None
    grid: ShardGrid
    rank: int

    @property
    def nb(self) -> int:
        return math.prod(self.bpd)

    @property
    def nb_loc(self) -> int:
        return math.prod(self.bpd_loc)

    @property
    def byx(self) -> int:
        return self.bpd_loc[2] * self.bpd_loc[3]

    @property
    def offset(self) -> tuple[int, ...]:
        """Global coordinates of this rank's first block."""
        coords = dict(zip(self.grid.axis_names, self.grid.coords(self.rank)))
        return (coords.get(self.axis_t, 0) * self.bpd_loc[0],
                coords.get(self.axis_z, 0) * self.bpd_loc[1], 0, 0)

    def local_block_map(self):
        return self.local_mesh.blocking(self.block)

    def _dims(self) -> dict:
        return {self.axis_t: 0, self.axis_z: 1}

    def gather_blocked(self, x, comm):
        """This rank's (Bt_loc, Bz_loc, rest...) -> the global (Bt, Bz,
        rest...) on every rank, row-major (bt, bz, by, bx) block order."""
        return join_shards(comm.all_gather(x), self.grid, self._dims())

    def local_coarse_slice(self, x):
        """Global (Bt, Bz, rest...) -> this rank's block rows."""
        return cut_shard(x, self.grid, self.rank, self._dims())


def _geometry(d: ShardLocalWilsonDirac, block) -> ShardGeom:
    if isinstance(block, int):
        block = (block,) * 4
    block = tuple(int(b) for b in block)
    lm = d.local_mesh
    for dim, b in zip(lm.spacetime_dims, block):
        if dim % b:
            raise ValueError(
                f"MG block extent {block} must divide the PER-SHARD lattice "
                f"{lm.spacetime_dims} (blocks may not straddle shards)"
            )
    return ShardGeom(
        mesh=d.mesh, local_mesh=lm, block=block,
        bpd=tuple(dd // b for dd, b in zip(d.mesh.spacetime_dims, block)),
        bpd_loc=tuple(dd // b for dd, b in zip(lm.spacetime_dims, block)),
        axis_t=d.axis_t, axis_z=d.axis_z, grid=d.comm.grid, rank=d.comm.rank,
    )


@dataclasses.dataclass(frozen=True)
class ShardLocalCoarseStencil(LinearOperator):
    """Shard-LOCAL 9-point Galerkin coarse operator over the block lattice.

    The coarse grid inherits the fine grid's (axis_t, axis_z) split: each
    rank owns its blocks' stencil rows ``blocks`` (bt_loc, bz_loc, by*bx,
    9, ne, ne) (complex) and their coarse dof, so the coarse solve is
    distributed too: the block planes a stencil reads across a shard edge
    come from the neighbouring rank, one exchange round per apply. Apply
    contract: this rank's flat (nb_loc * ne,) CF -> the same; every rank
    must apply it together."""

    blocks: torch.Tensor
    geom: ShardGeom
    comm: object

    @property
    def ne(self) -> int:
        return self.blocks.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        n = self.geom.nb * self.ne  # global dimension
        return (n, n)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def _neighbours(self, xg):
        """[x(b + mu), x(b - mu) for mu in t, z, y, x] of the local
        (bt, bz, by, bx, ne) coarse field; t and z planes past the shard's
        edges come from the ring neighbours."""
        g = self.geom
        names = (g.axis_t, g.axis_z)
        split = [d for d in (0, 1) if self.comm.axis_size(names[d]) > 1]
        items = []
        for d in split:  # planes travel as real (..., 2) tensors
            n = xg.shape[d]
            items += [(torch.view_as_real(xg.narrow(d, 0, 1)).contiguous(), names[d], 1),
                      (torch.view_as_real(xg.narrow(d, n - 1, 1)).contiguous(), names[d], -1)]
        got = iter([torch.view_as_complex(p) for p in self.comm.exchange(items)] if items else [])
        out = []
        for d in range(4):
            if d in split:
                n = xg.shape[d]
                nxt, prv = next(got), next(got)
                out += [torch.cat([xg.narrow(d, 1, n - 1), nxt], d),
                        torch.cat([prv, xg.narrow(d, 0, n - 1)], d)]
            else:
                out += [torch.roll(xg, -1, d), torch.roll(xg, 1, d)]
        return out

    def apply(self, x):
        g = self.geom
        ne = self.ne
        xc = torch.complex(x.re, x.im) if cplx.is_cf(x) else x
        xg = xc.reshape(*g.bpd_loc, ne)
        bg = self.blocks.to(xc.dtype).reshape(*g.bpd_loc, 9, ne, ne)
        eq = "abcdij,abcdj->abcdi"
        y = torch.einsum(eq, bg[..., 0, :, :], xg)
        for s, nb in enumerate(self._neighbours(xg)):
            y = y + torch.einsum(eq, bg[..., 1 + s, :, :], nb)
        y = y.reshape(xc.shape)
        return cplx.CF(y.real.contiguous(), y.imag.contiguous()) if cplx.is_cf(x) else y


# ---------------------------------------------------------------------------
# the sharded preconditioner
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardedMGPreconditioner(LinearOperator):
    """MG preconditioner whose fine level lives on this rank's shard.

    ``q_field`` is the shard's field-shaped per-block orthonormal basis
    (ne, 4, 3, T_l, Z_l, Y*X), so the transfer kernels B10/B11 run on the
    shard unchanged; ``coarse`` is a ``ShardLocalCoarseStencil`` or a
    replicated dense / block-ELL operator, and ``coarse_precond`` the
    replicated deeper hierarchy. ``apply`` (= ``local_apply``) is the
    V-cycle on this rank's shard; every rank must call it together."""

    a: LinearOperator  # DiracOperator over this rank's ShardLocalWilsonDirac
    q_field: cplx.CF  # (ne, 4, 3, T_l, Z_l, Y*X)
    coarse: LinearOperator
    geom: ShardGeom
    params: MGParams
    coarse_precond: LinearOperator | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.a.shape

    @property
    def comm(self):
        return _unwrap(self.a)[0].comm

    @property
    def q5(self) -> cplx.CF:
        """The shard's blocked basis (ne, Bt_loc, Bz_loc, By*Bx, block_len)."""
        g = self.geom
        lbm = g.local_block_map()
        ne = self.q_field.shape[0]
        return lbm.to_blocked_tpu(self.q_field).reshape(ne, g.bpd_loc[0], g.bpd_loc[1], g.byx,
                                                        lbm.block_len)

    def restrict(self, x) -> cplx.CF:
        """P^H x on the shard: this rank's (nb_loc * ne,) coarse rows (B10)."""
        return transfer.restrict(self.q_field, self.geom.local_block_map(), x)

    def prolong(self, xc, base=None, damping: float = 1.0):
        """base + damping * P xc on the shard (B11)."""
        return transfer.prolong(self.q_field, self.geom.local_block_map(), xc, base, damping)

    def _coarse_solve(self, rc):
        """This rank's rows of the coarse correction C^-1 rc."""
        g, comm, coarse = self.geom, self.comm, self.coarse
        cp = self.coarse_precond
        if isinstance(coarse, ShardLocalCoarseStencil):
            precond = None
            if cp is not None:
                # levels >= 3 are replicated: one coarse-dof gather per
                # application of the deeper V-cycle
                ne_c = coarse.ne

                def precond(rc_p):
                    blocked = rc_p.reshape(g.bpd_loc[0], g.bpd_loc[1], g.byx, ne_c)
                    rep = g.gather_blocked(blocked, comm).reshape(g.nb * ne_c)
                    ec = cp.apply(rep).reshape(g.bpd[0], g.bpd[1], g.byx, ne_c)
                    return g.local_coarse_slice(ec).reshape(g.nb_loc * ne_c)

            return gcr_solve(coarse, rc, self.params.coarse_gcr, precond=precond, comm=comm).x
        ne = rc.shape[0] // g.nb_loc
        rc_g = g.gather_blocked(rc.reshape(g.bpd_loc[0], g.bpd_loc[1], g.byx, ne), comm)
        ec = gcr_solve(coarse, rc_g.reshape(g.nb * ne), self.params.coarse_gcr,
                       precond=cp.apply if cp is not None else None).x
        return g.local_coarse_slice(ec.reshape(g.bpd[0], g.bpd[1], g.byx, ne)).reshape(
            g.nb_loc * ne)

    def _smooth(self, rhs, x, n: int):
        sp = self.params.smoother_gcr
        for _ in range(n):
            r = rhs - self.a.apply(x)
            x = x + gcr_solve(self.a, r, sp, comm=self.comm).x
        return x

    def local_apply(self, r):
        """One V-cycle, or the additive coarse deflation with the smoother
        off, on this rank's shard (the cycle of the JAX package's
        ``ShardedMGPreconditioner.local_apply``)."""
        damping = self.params.correction_damping
        if self.params.smoother_gcr is None:
            return self.prolong(self._coarse_solve(self.restrict(r)), base=r, damping=damping)
        x = self._smooth(r, cplx.zeros_like(r), self.params.n_pre_smooth)
        ec = self._coarse_solve(self.restrict(r - self.a.apply(x)))
        x = self.prolong(ec, base=x, damping=damping)
        return self._smooth(r, x, self.params.n_post_smooth)

    def apply(self, r):
        return self.local_apply(r)

    def as_preconditioner(self):
        return self.apply


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------
def _replicated_stencil(blocks_global: torch.Tensor, geom: ShardGeom):
    """The replicated operator of the global stencil blocks (nb, 9, ne, ne),
    row-major (bt, bz, by, bx) block order."""
    table = geom.mesh.blocking(geom.block).neighbor_table()
    return build_coarse_operator(blocks_global, table, "stencil", geom.bpd)


def setup_mg_sharded(
    generator: torch.Generator,
    a: LinearOperator,
    params: MGParams,
    b0: cplx.CF | None = None,
    timings: dict | None = None,
) -> ShardedMGPreconditioner:
    """This rank's part of the adaptive-MG setup over a lattice split into
    (t, z) shards; every rank must call it together.

    ``a``: a ``DiracOperator`` over this rank's ``ShardLocalWilsonDirac``
    (or the bare operator). The block extent must divide the shard.
    ``b0`` seeds the power iteration: the GLOBAL field (4, 3, T, Z, Y*X),
    cut here; else it is drawn from ``generator`` (on the operator's
    device, seeded alike on every rank) at the global shape, as
    ``setup_mg`` draws it, so that one seed gives the single-device
    hierarchy (the parity contract of the JAX package's tests). Deeper
    levels draw their start vectors from ``generator`` after it.
    ``timings``, when given, receives this rank's wall seconds per phase
    (power, orthonormalise, galerkin, coarse_operator, coarse_levels), the
    device synchronised at each phase end."""
    import time

    d, _ = _unwrap(a)
    comm = d.comm
    _check_params(params)
    _check_transfer_backend(params, d.device)
    if params.smoother != "gcr":
        raise ValueError("the sharded V-cycle smooths with GCR (smoother='gcr')")
    geom = _geometry(d, params.block)
    lbm = geom.local_block_map()
    rdt, dev = d.dtype, d.device
    ne = 2 * params.n_nullvecs
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *_: None)
    clock = [time.perf_counter()]

    def phase(name):
        if timings is not None:
            sync(dev)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    t, z, y, xx = geom.mesh.spacetime_dims
    if b0 is None:
        b0 = cplx.random(generator, (4, 3, t, z, y * xx), rdt, device=dev)
    b0_loc = shard_field(b0, comm.grid, comm.rank, d.axis_t, d.axis_z).to(dev)
    del b0

    vecs = inverse_power_vectors(a, b0_loc, params.n_nullvecs, params.setup_gcr,
                                 params.setup_power_iters, comm=comm)
    phase("power")
    q_field = field_basis(block_orthonormalize(chiral_double(vecs, layout="tpu"), lbm, "tpu"),
                          lbm)
    del vecs
    phase("orthonormalise")
    blocks, _ = galerkin_coarse_blocks(a, q_field, lbm, "tpu", grid_bpd=geom.bpd,
                                       block_offset=geom.offset)
    phase("galerkin")
    blocks6 = blocks.reshape(geom.bpd_loc[0], geom.bpd_loc[1], geom.byx, 9, ne, ne)
    del blocks
    stencil = params.coarse_format == "stencil"
    blocks_global = None
    if stencil:
        coarse = ShardLocalCoarseStencil(blocks6, geom, comm)
    else:
        blocks_global = geom.gather_blocked(blocks6, comm).reshape(geom.nb, 9, ne, ne)
        table = geom.mesh.blocking(geom.block).neighbor_table()
        coarse = build_coarse_operator(blocks_global, table, params.coarse_format, geom.bpd)
    phase("coarse_operator")

    # levels >= 3: replicated, set up as the single-device hierarchy's; for
    # the shard-local stencil, the same global blocks back a replicated
    # operator used only by the deeper levels
    coarse_precond = None
    cb = params.coarse_block
    if params.n_level > 2 and all(dd % cb == 0 and dd >= cb for dd in geom.bpd):
        if stencil:
            blocks_global = geom.gather_blocked(blocks6, comm).reshape(geom.nb, 9, ne, ne)
            deeper_fine = _replicated_stencil(blocks_global, geom)
        else:
            deeper_fine = coarse

        def draw(level, shape, rdt_, dev_):
            return cplx.random(generator, shape, rdt_, device=dev_)

        coarse_precond = _setup_level(
            draw, deeper_fine, LatticeMesh((*geom.bpd, ne), n_spacetime=4), params, 2, "flat",
            coarse_gamma5_fn(ne), None, None,
        )
    phase("coarse_levels")
    if params.transfer_dtype is not None:
        q_field = q_field.astype(_STORAGE[params.transfer_dtype])
    return ShardedMGPreconditioner(a, q_field, coarse, geom, params, coarse_precond)


# ---------------------------------------------------------------------------
# distributed MG-GCR driver
# ---------------------------------------------------------------------------
def mg_gcr_solve_sharded(
    rhs,
    params: GCRParams,
    mgp: ShardedMGPreconditioner,
    x0=None,
    fused: Optional[bool] = None,
) -> SolveResult:
    """This rank's part of the distributed MG-preconditioned GCR solve:
    ``gcr_solve`` on the shard with the communicator, the V-cycle of
    ``mgp`` as the flexible right preconditioner. ``rhs`` and ``x0`` are
    this rank's slabs; the result's x is this rank's slab, its scalars the
    global ones. Every rank must call it together."""
    return gcr_solve(mgp.a, rhs, params, precond=mgp.apply, x0=x0, fused=fused, comm=mgp.comm)


def mg_gcr_solve_grid(links_canonical, mesh: LatticeMesh, k, rhs, params: GCRParams,
                      mg_params: MGParams, grid: ShardGrid, axis_t="t",
                      axis_z=None) -> SolveResult:
    """The sharded MG setup and the distributed MG-GCR solve of
    (I - kD) x = rhs in one process: every rank of ``grid`` runs as a thread
    (``run_spmd``) on its device, builds its ``ShardLocalWilsonDirac``, sets
    up the hierarchy (start vector drawn from a generator seeded with 0 on
    every rank) and solves; the result's ``x`` is the gathered global
    solution, its scalars rank 0's, which every rank shares.
    ``links_canonical`` is as ``ShardLocalWilsonDirac.build`` takes it."""

    def rank_solve(comm):
        d = ShardLocalWilsonDirac.build(links_canonical, mesh, comm, axis_t, axis_z)
        a = DiracOperator(d, k)
        gen = torch.Generator(device=comm.device).manual_seed(0)
        mgp = setup_mg_sharded(gen, a, mg_params)
        b = shard_field(rhs, grid, comm.rank, axis_t, axis_z).to(comm.device)
        return mg_gcr_solve_sharded(b, params, mgp)

    results = run_spmd(grid, rank_solve)
    x = gather_field([res.x for res in results], grid, axis_t, axis_z)
    return dataclasses.replace(results[0], x=x)
