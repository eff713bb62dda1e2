"""Two-level adaptive multigrid preconditioner on slab fields.

Counterpart of ``mgpgcr_tpu/solvers/mg.py`` for its ``layout="tpu"`` path
(split re/im ``cplx.CF`` fields ``(4, 3, T, Z, Y*X)``), two levels, the
dense coarse operator and the phase-probed Galerkin assembly.

Setup (the reference's ``MG::initialise``, MG.h:132-285): near-null
vectors by inverse power iteration, chiral doubling, per-block modified
Gram--Schmidt on the blocked vectors, the field-shaped basis ``q_field``
``(ne, 4, 3, T, Z, Y*X)``, and C = P^H A P from 9-point phase probes, one
basis column at a time. The probes restrict through the transfer kernel.

Apply (``MG::solve``, MG.h:406-430): a V-cycle (GCR or Neumann smoother,
restricted-residual coarse solve, prolongated correction fused with its
base) or, with the smoother off, the deflation M = I + P C^-1 P^H.
Restrict and prolong run the hand-written transfer kernels for CUDA
tensors and their plain versions for CPU tensors (``kernels/transfer.py``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import transfer
from mgpgcr_tpu_torch.mesh import BlockMap, LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.dense import DenseOperator
from mgpgcr_tpu_torch.ops.wilson_slab import gamma5_slab
from mgpgcr_tpu_torch.solvers.gcr import gcr_solve
from mgpgcr_tpu_torch.solvers.params import MGParams
from mgpgcr_tpu_torch.solvers.power import inverse_power_vectors

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class MGPreconditioner(LinearOperator):
    a: LinearOperator  # fine operator
    q_field: cplx.CF  # (ne, 4, 3, T, Z, Y*X) per-block orthonormal basis
    coarse: DenseOperator  # Galerkin coarse operator
    block_map: BlockMap
    params: MGParams
    # cheaper operator for the smoother solves only (e.g. bf16 links,
    # ops/wilson_slab.with_link_dtype); the outer residual uses ``a``
    a_smooth: LinearOperator | None = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.a.shape

    def restrict(self, x):
        """R x = P^H x: slab field -> coarse (nb*ne,) CF."""
        return transfer.restrict(self.q_field, self.block_map, x)

    def prolong(self, xc, base=None, damping: float = 1.0):
        """base + damping * P xc (base None: 0) in one pass."""
        return transfer.prolong(self.q_field, self.block_map, xc, base, damping)

    def _neumann_smooth(self, a, rhs, x, x_is_zero: bool):
        """x + sum_{i<terms} (kD)^i r with r the current residual; (kD) t =
        t - A t, so each further term is one operator pass."""
        r = rhs if x_is_zero else rhs - a.apply(x)
        acc = r
        t = r
        for _ in range(self.params.smoother_terms - 1):
            t = t - a.apply(t)
            acc = acc + t
        return acc if x_is_zero else x + acc

    @property
    def _has_smoother(self) -> bool:
        return self.params.smoother == "neumann" or self.params.smoother_gcr is not None

    def _smooth(self, rhs, x, n: int, x_is_zero: bool = False):
        a = self.a_smooth if self.a_smooth is not None else self.a
        if self.params.smoother == "neumann":
            for i in range(n):
                x = self._neumann_smooth(a, rhs, x, x_is_zero and i == 0)
            return x
        sp = self.params.smoother_gcr
        if sp is None:
            return x
        for i in range(n):
            # from x = 0 the solver starts at r = rhs; a warm start
            # computes r = rhs - A x in the solver's own first apply
            x = gcr_solve(a, rhs, sp).x if x_is_zero and i == 0 else gcr_solve(a, rhs, sp, x0=x).x
        return x

    def apply(self, r):
        """One V(pre, post)-cycle approximating A^{-1} r (smoother on), or
        the additive deflation M = I + P C^-1 P^H (smoother off)."""

        def coarse_correct(res, base):
            ec = gcr_solve(self.coarse, self.restrict(res), self.params.coarse_gcr).x
            return self.prolong(ec, base=base, damping=self.params.correction_damping)

        if not self._has_smoother:
            return coarse_correct(r, r)
        x = self._smooth(r, cplx.zeros_like(r), self.params.n_pre_smooth, x_is_zero=True)
        x = coarse_correct(r - self.a.apply(x), x)
        return self._smooth(r, x, self.params.n_post_smooth)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------
def chiral_double(vecs: cplx.CF) -> cplx.CF:
    """(n, 4, 3, T, Z, V) -> (2n, ...): [P_+ v_i ...; P_- v_i ...] with
    P_+- = (1 +- gamma_5) / 2 (MG.h:317-345)."""
    g5 = gamma5_slab(vecs)
    return cplx.concatenate(
        [cplx.scale_real(vecs + g5, 0.5), cplx.scale_real(vecs - g5, 0.5)], axis=0
    )


def _row_dots(q: cplx.CF, v: cplx.CF) -> torch.Tensor:
    """<q_b, v_b> for each row b of two (nb, bl) CFs: complex (nb,)."""
    return torch.complex(
        (q.re * v.re + q.im * v.im).sum(1), (q.re * v.im - q.im * v.re).sum(1)
    )


def _batched_mgs(mats: cplx.CF) -> cplx.CF:
    """Per-block modified Gram--Schmidt with one reorthogonalisation pass:
    (ne, nb, bl) -> orthonormal columns in the same layout."""
    ne = mats.shape[0]
    cols = []
    for e in range(ne):
        v = mats[e]
        for _ in range(2):
            for qj in cols:
                v = v - qj * _row_dots(qj, v)[:, None]
        nrm = torch.sqrt(cplx.abs2(v).sum(1, keepdim=True))
        cols.append(cplx.scale_real(v, 1.0 / nrm))
    return cplx.stack(cols, axis=0)


def block_orthonormalize(vecs: cplx.CF, block_map: BlockMap) -> cplx.CF:
    """Per-block orthonormal basis (ne, nb, block_len) of (ne, 4, 3, T, Z, V)
    vectors; replaces the reference's serial per-block Gram--Schmidt
    (MG.h:190-198) with the same column span."""
    blocked = block_map.to_blocked_tpu(vecs)
    if blocked.shape[2] < blocked.shape[0]:
        raise ValueError("block_len smaller than number of coarse vectors")
    return _batched_mgs(blocked)


def field_basis(q: cplx.CF, block_map: BlockMap) -> cplx.CF:
    """Blocked basis (ne, nb, bl) -> field-shaped (ne, 4, 3, T, Z, Y*X)."""
    return block_map.from_blocked_tpu(q).contiguous()


def stencil_from_probes(measure, bpd):
    """The 9-point stencil slots [self, +d0, -d0, ...] per coarse row from
    the phase-probe measurements ``measure(p)``: per dimension a
    Vandermonde system in (self-rest, +mu, -mu) solved from exponents
    p_mu in {0, 1, 2}; a 2-block dimension merges +-mu into the + slot, a
    1-block dimension folds them into the diagonal."""
    ns = len(bpd)
    m0 = measure((0,) * ns)
    zero = torch.zeros_like(m0)
    slots = [None] * (2 * ns + 1)
    diag = m0
    for mu in range(ns):
        d = bpd[mu]
        if d == 1:
            slots[1 + 2 * mu] = zero
            slots[2 + 2 * mu] = zero
            continue
        e_mu = tuple(1 if i == mu else 0 for i in range(ns))
        m1 = measure(e_mu)
        if d == 2:
            c = (m0 - m1) * 0.5
            slots[1 + 2 * mu] = c
            slots[2 + 2 * mu] = zero
            diag = diag - c
            continue
        m2 = measure(tuple(2 * x for x in e_mu))
        w = np.exp(2j * np.pi / d)
        d1 = m1 - m0
        d2 = m2 - m0
        c11, c12 = complex(w - 1), complex(np.conj(w) - 1)
        c21, c22 = complex(w**2 - 1), complex(np.conj(w) ** 2 - 1)
        det = c11 * c22 - c12 * c21
        a_co = d1 * (c22 / det) - d2 * (c12 / det)
        b_co = d2 * (c11 / det) - d1 * (c21 / det)
        slots[1 + 2 * mu] = a_co
        slots[2 + 2 * mu] = b_co
        diag = diag - a_co - b_co
    slots[0] = diag
    return slots


def galerkin_coarse_blocks(a, q_field: cplx.CF, block_map: BlockMap):
    """Phase-probed Galerkin assembly: (nb, 9, ne, ne) complex stencil
    blocks and the (nb, 9) neighbour table, from 9 x ne operator
    applications whatever the block count. Each probe activates every
    block's basis column e at once, modulated by chi_p(B) = prod_mu
    omega_mu^(p_mu B_mu), applies A and restricts; columns go one at a
    time, so the transient is two fields."""
    ne = q_field.shape[0]
    nb = block_map.n_blocks
    bpd = block_map.blocks_per_dim
    dev = q_field.device
    cdt = cplx.complex_dtype(q_field.dtype)
    site_blocks = torch.as_tensor(block_map.site_blocks(), device=dev)

    def measure(p):
        """M_p[r; f, e] = sum_b chi_p(B_b) <phi_{r,f}, A phi_{b,e}>, un-phased
        by conj(chi_p(B_r)): (nb, ne_row, ne_col)."""
        grids = np.indices(bpd)
        theta = sum(2.0 * np.pi * p[mu] * grids[mu] / bpd[mu] for mu in range(len(bpd)))
        chi = torch.as_tensor(np.exp(1j * np.asarray(theta, np.float64)).reshape(-1)).to(dev, cdt)
        chi_sites = chi[site_blocks]
        cols = []
        for e in range(ne):
            rc = transfer.restrict(q_field, block_map, a.apply(q_field[e] * chi_sites))
            cols.append(torch.complex(rc.re, rc.im).reshape(nb, ne))
        rbb = torch.stack(cols) * chi.conj()[None, :, None]  # (e_col, nb, f_row)
        return rbb.permute(1, 2, 0)

    slots = stencil_from_probes(measure, bpd)
    return torch.stack(slots, dim=1), block_map.neighbor_table()


def blocks_to_dense(blocks: torch.Tensor, table) -> torch.Tensor:
    """(nb, 9, ne, ne) stencil blocks -> dense Galerkin matrix (nc, nc)."""
    nb, k, ne, _ = blocks.shape
    dev = blocks.device
    rows = np.arange(nb)[:, None, None, None] * ne + np.arange(ne)[None, None, :, None]
    cols = np.asarray(table)[:, :, None, None] * ne + np.arange(ne)[None, None, None, :]
    rows = torch.as_tensor(np.broadcast_to(rows, blocks.shape).reshape(-1), device=dev)
    cols = torch.as_tensor(np.broadcast_to(cols, blocks.shape).reshape(-1), device=dev)
    nc = nb * ne
    flat = blocks.reshape(-1)
    parts = []
    for part in (flat.real, flat.imag):
        dense = torch.zeros((nc, nc), dtype=part.dtype, device=dev)
        # duplicate (row, col) pairs only ever add a zero block: exact
        dense.index_put_((rows, cols), part, accumulate=True)
        parts.append(dense)
    return torch.complex(*parts)


def build_coarse_operator(blocks, table, coarse_format: str) -> DenseOperator:
    """The coarse operator in ``coarse_format``; the port has "dense"."""
    if coarse_format != "dense":
        raise NotImplementedError(
            f"coarse_format={coarse_format!r}: the block-ELL and block-stencil "
            "coarse operators wait in ROADMAP A7 (with kernel B12)"
        )
    return DenseOperator(blocks_to_dense(blocks, table))


def _check_transfer_backend(params: MGParams, device) -> None:
    """The port has one transfer route, "auto": the kernels for CUDA
    tensors, their plain versions for CPU tensors. Any other value of the
    JAX field names a route the port does not have on the card."""
    if params.transfer_backend != "auto" and torch.device(device).type == "cuda":
        raise ValueError(
            f"transfer_backend={params.transfer_backend!r}: on CUDA tensors the port "
            "runs the transfer kernels; use 'auto'"
        )


def _field_spec(a):
    """(field shape, real dtype, device) of the fine operator's fields."""
    d = getattr(a, "d", a)
    return d.field_shape, d.dtype, d.device


def setup_mg(
    generator: torch.Generator,
    a: LinearOperator,
    mesh: LatticeMesh,
    params: MGParams,
    smoother_operator: LinearOperator | None = None,
    timings: dict | None = None,
) -> MGPreconditioner:
    """Adaptive-MG setup on slab fields (MG::initialise, MG.h:132-285),
    ``n_level=2``: the start vector b0 is drawn from ``generator`` (which
    lives on the operator's device) and handed to :func:`setup_mg_from`."""
    shape, rdt, dev = _field_spec(a)
    b0 = cplx.random(generator, shape, rdt, device=dev)
    return setup_mg_from(b0, a, mesh, params, smoother_operator, timings)


def setup_mg_from(
    b0: cplx.CF,
    a: LinearOperator,
    mesh: LatticeMesh,
    params: MGParams,
    smoother_operator: LinearOperator | None = None,
    timings: dict | None = None,
) -> MGPreconditioner:
    """:func:`setup_mg` from an explicit start vector ``b0``. ``timings``,
    when given, receives the wall seconds of each phase (power, orthonormalise,
    galerkin, dense), the device synchronised at each phase end."""
    if params.n_level != 2:
        raise NotImplementedError("n_level > 2 waits in ROADMAP (recursive coarse levels)")
    if params.assembly != "phased":
        raise NotImplementedError("assembly='columns' waits in ROADMAP; use 'phased'")
    _check_transfer_backend(params, b0.device)
    sync = torch.cuda.synchronize if b0.device.type == "cuda" else (lambda *_: None)
    clock = [time.perf_counter()]

    def phase(name):
        if timings is not None:
            sync(b0.device)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    vecs = inverse_power_vectors(
        a, b0, params.n_nullvecs, params.setup_gcr, params.setup_power_iters
    )
    phase("power")
    block_map = mesh.blocking(params.block)
    q_field = field_basis(block_orthonormalize(chiral_double(vecs), block_map), block_map)
    del vecs
    phase("orthonormalise")
    blocks, table = galerkin_coarse_blocks(a, q_field, block_map)
    phase("galerkin")
    coarse = build_coarse_operator(blocks, table, params.coarse_format)
    phase("dense")
    if params.transfer_dtype is not None:
        q_field = q_field.astype(_STORAGE[params.transfer_dtype])
    return MGPreconditioner(a, q_field, coarse, block_map, params, smoother_operator)


def mg_from_numpy(
    a: LinearOperator,
    mesh: LatticeMesh,
    q_field,
    coarse,
    params: MGParams,
    a_smooth: LinearOperator | None = None,
    device=None,
) -> MGPreconditioner:
    """The JAX package's MG hierarchy -> the port's ``MGPreconditioner`` on
    ``device`` (CUDA unless named).

    ``q_field``: the field-shaped basis (ne, 4, 3, T, Z, Y*X) and
    ``coarse``: the dense Galerkin matrix (nc, nc), each a complex ndarray
    or an (re, im) pair of ndarrays; the block extent is
    ``params.block``. The basis is stored in the operator's field dtype,
    or in ``params.transfer_dtype``."""
    dev = cplx.resolve_device(device)
    _check_transfer_backend(params, dev)
    _, rdt, _ = _field_spec(a)

    def complex_np(z):
        return z[0] + 1j * np.asarray(z[1]) if isinstance(z, (tuple, list)) else np.asarray(z)

    qf = cplx.from_numpy(complex_np(q_field), rdt, dev)
    if params.transfer_dtype is not None:
        qf = qf.astype(_STORAGE[params.transfer_dtype])
    dense = torch.as_tensor(complex_np(coarse)).to(dev, cplx.complex_dtype(rdt))
    return MGPreconditioner(a, qf, DenseOperator(dense), mesh.blocking(params.block), params,
                            a_smooth)
