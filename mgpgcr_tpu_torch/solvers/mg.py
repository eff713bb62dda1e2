"""Adaptive multigrid preconditioner: the slab and flat layouts, the
dense, block-ELL and block-stencil coarse operators, any number of levels.

Counterpart of ``mgpgcr_tpu/solvers/mg.py``. Two field layouts, with the
JAX package's names:
- ``"tpu"``, the slab layout: split re/im ``cplx.CF`` fields
  ``(4, 3, T, Z, Y*X)`` and the field-shaped basis ``q_field`` ``(ne, 4, 3,
  T, Z, Y*X)``; restrict and prolong run the transfer kernels B10 and B11
  for CUDA tensors and their plain versions for CPU tensors
  (``kernels/transfer.py``);
- ``"flat"``: canonical flat CF fields ``(N,)`` and the blocked basis ``q``
  ``(ne, nb, block_len)``; restrict and prolong are ``einsum``s, as the JAX
  form is XLA. Every level below the first runs here, on the flat CF fields
  of ``LatticeMesh((*blocks_per_dim, ne), n_spacetime=4)``, with the level
  above's coarse operator as its fine operator.

Setup (the reference's ``MG::initialise``, MG.h:132-285): near-null vectors
by inverse power iteration, chiral doubling, per-block modified
Gram--Schmidt on the blocked vectors, and C = P^H A P assembled from
9-point phase probes ("phased", one basis column at a time) or by a sweep
over block columns ("columns", the dense matrix). The coarse operator is
"dense" (``DenseOperator``), "bsr" (``BlockSparseOperator``) or "stencil"
(``StencilBlockOperator``, which runs the block-stencil kernel B12).

Apply (``MG::solve``, MG.h:406-430): a V-cycle (GCR or Neumann smoother,
restricted-residual coarse solve, prolongated correction fused with its
base) or, with the smoother off, the deflation M = I + P C^-1 P^H; the
coarse GCR is preconditioned by the next level's V-cycle when there is one.
The coarse GCR runs one restart cycle at a time with one host read per
cycle (``CoarseSolve``); on the card, without a next level, each cycle is
a CUDA graph replay, of the coarse GCR kernels on float32 fields
(``KernelCycle``). Each smoother sweep runs under the profiler span
``mg.smooth`` and is counted with its iterations (``smoother_counts``).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx, fields
from mgpgcr_tpu_torch.kernels import credit_launches, launch_counts, transfer
from mgpgcr_tpu_torch.kernels.coarse_gcr import (
    MAX_ROWS,
    CycleScalars,
    coarse_gcr_dir,
    coarse_gcr_dots,
    coarse_gcr_start,
    coarse_gcr_update,
)
from mgpgcr_tpu_torch.mesh import BlockMap, LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.blockstencil import StencilBlockOperator
from mgpgcr_tpu_torch.ops.bsr import BlockSparseOperator
from mgpgcr_tpu_torch.ops.dense import DenseOperator
from mgpgcr_tpu_torch.ops.wilson_slab import gamma5_slab
from mgpgcr_tpu_torch.solvers.gcr import GenericLoop, gcr_solve
from mgpgcr_tpu_torch.solvers.params import GCRParams, MGParams
from mgpgcr_tpu_torch.solvers.power import inverse_power_vectors
from mgpgcr_tpu_torch.utils.profiling import annotate

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}
_FORMATS = ("dense", "bsr", "stencil")


# ---------------------------------------------------------------------------
# grid transfers
# ---------------------------------------------------------------------------
def _to_blocked(block_map: BlockMap, x, layout: str):
    return block_map.to_blocked_tpu(x) if layout == "tpu" else block_map.to_blocked(x)


def _from_blocked(block_map: BlockMap, xb, layout: str):
    return block_map.from_blocked_tpu(xb) if layout == "tpu" else block_map.from_blocked(xb)


def _einsum_cf(eq: str, a: cplx.CF, b: cplx.CF, conj_a: bool = False) -> cplx.CF:
    """The complex einsum of two CFs in real arithmetic of b's dtype."""
    a = a.astype(b.dtype)
    ai = -a.im if conj_a else a.im
    return cplx.CF(torch.einsum(eq, a.re, b.re) - torch.einsum(eq, ai, b.im),
                   torch.einsum(eq, a.re, b.im) + torch.einsum(eq, ai, b.re))


def restrict(q, block_map: BlockMap, x, layout: str = "flat") -> cplx.CF:
    """R x = P^H x: a fine field (..., N) (or a slab field for "tpu") ->
    (..., nb * ne), b-major / e-minor (MG::restrict, MG.h:367-383). q is the
    blocked basis (ne, nb, block_len); CFs, or complex tensors."""
    q, x = cplx.ascf(q), cplx.ascf(x)
    rc = _einsum_cf("ebk,...bk->...be", q, _to_blocked(block_map, x, layout), conj_a=True)
    return rc.reshape(tuple(rc.shape[:-2]) + (q.shape[0] * q.shape[1],))


def prolong(q, block_map: BlockMap, xc, layout: str = "flat") -> cplx.CF:
    """P xc: (..., nb * ne) -> a fine field (MG::expand, MG.h:348-364)."""
    q, xc = cplx.ascf(q), cplx.ascf(xc)
    ne, nb, _ = q.shape
    xcb = xc.reshape(tuple(xc.shape[:-1]) + (nb, ne))
    return _from_blocked(block_map, _einsum_cf("ebk,...be->...bk", q, xcb), layout)


def _restrict_any(basis: cplx.CF, block_map: BlockMap, x, layout: str) -> cplx.CF:
    """R x with the basis of ``layout``: q_field through the transfer
    kernel ("tpu"), or the blocked q ("flat")."""
    if layout == "tpu":
        return transfer.restrict(basis, block_map, x)
    return restrict(basis, block_map, x, "flat")


# how the V-cycles' coarse GCR ran its restart cycles, for every hierarchy
_CYCLES = {"captures": 0, "replays": 0, "eager_cycles": 0, "kernel_cycles": 0}


def coarse_cycle_counts() -> dict[str, int]:
    """CUDA graphs captured for the coarse GCR, restart cycles replayed from
    them, restart cycles run eagerly, and restart cycles run through the
    coarse GCR kernels (``KernelCycle``, eagerly or replayed), since the
    last reset."""
    return dict(_CYCLES)


def reset_coarse_cycle_counts() -> None:
    for k in _CYCLES:
        _CYCLES[k] = 0


# the V-cycles' smoother solves (pre and post) and their iterations
_SMOOTH = {"calls": 0, "iterations": 0}


def smoother_counts() -> dict[str, int]:
    """Smoother solves run by the V-cycles (each pre- and post-smoothing
    sweep is one) and their iterations (GCR iterations, or Neumann terms),
    since the last reset."""
    return dict(_SMOOTH)


def reset_smoother_counts() -> None:
    for k in _SMOOTH:
        _SMOOTH[k] = 0


def _alone() -> bool:
    """True where a CUDA graph capture can be the process's only CUDA work
    while it lasts: not in a rank thread of ``run_spmd`` nor in a
    ``torch.distributed`` group, where the sharded MG (``mg_dist.py``) runs
    its replicated levels."""
    return threading.current_thread() is threading.main_thread() and not (
        torch.distributed.is_available() and torch.distributed.is_initialized())


class KernelCycle:
    """Restarted GCR on flat CF vectors through the coarse GCR kernels
    (``kernels/coarse_gcr.py``), one restart cycle a call: the recurrence of
    the generic loop (``solvers/gcr.py``, reference GCR.h:222-288) with no
    preconditioner, every scalar of it on the device (``CycleScalars``).

    An iteration is the apply az = A r and three kernels: the betas against
    the live rows, the new direction into its ring row (with the restart's
    clearing of the stored norms, alpha and the active flag), and the x and
    r update (with r2, it, the history and the flag ``going``). A solve
    opens with ``coarse_gcr_start``, A r and the first direction; a later
    cycle opens with the restart's direction, orthogonalised against the
    whole stack and stored in row 0. Count, ring slot and the live prefix
    do not depend on the data: iteration c of a cycle (c = 1 .. restart -
    1) takes lim = slot = c. Iterations past convergence or past
    ``max_iter`` run masked (alpha 0, r2, it and the history held).

    Every tensor is made here, so a cycle's launches read and write only
    this object's buffers: the form a CUDA graph replays."""

    def __init__(self, a, rhs, params: GCRParams):
        self.apply_a = a.apply if hasattr(a, "apply") else a
        self.rhs, self.restart = rhs, params.restart
        self.check_every = self.restart  # iterations between host checks
        self.x, self.r = cplx.zeros_like(rhs), cplx.zeros_like(rhs)
        self.ps, self.aps = cplx.stack_zeros(self.restart, rhs), cplx.stack_zeros(self.restart, rhs)
        self.sc = CycleScalars(self.restart, params.tol, params.max_iter, rhs.dtype, rhs.device)
        self.opened = False
        self.state = {"x": self.x, "it": self.sc.it, "hist": self.sc.hist, "going": self.sc.going}

    def _iteration(self, c: int) -> None:
        """The direction of count c (0: the solve's first; restart: the
        restart's, into row 0) and the update of x and r along it."""
        slot = c % self.restart
        az = self.apply_a(self.r)
        if c:
            coarse_gcr_dots(self.aps, az, c, self.sc)
        coarse_gcr_dir(self.r, az, self.ps, self.aps, slot, c, slot == 0, self.sc)
        coarse_gcr_update(self.x, self.r, self.ps, self.aps, slot, self.sc)

    def cycle(self) -> None:
        """One restart cycle, ``restart`` iterations, with no host read."""
        if self.opened:
            self._iteration(self.restart)
        else:
            coarse_gcr_start(self.rhs, self.x, self.r, self.sc)
            self._iteration(0)
            self.opened = True
        for c in range(1, self.restart):
            self._iteration(c)


def _graphed(rhs, params: GCRParams, precond) -> bool:
    """Whether the coarse GCR's cycles are captured as CUDA graphs: CUDA
    fields, no coarse preconditioner (the coarsest level), restart mode
    without residual_refresh, and a process that runs no other rank
    (``_alone``)."""
    return (rhs.device.type == "cuda" and precond is None and bool(params.restart)
            and not params.residual_refresh and _alone())


def _kernel_cycles(rhs, params: GCRParams, precond) -> bool:
    """Whether the coarse GCR runs through the coarse GCR kernels
    (``KernelCycle``): where it is graphed, on float32 fields, with a
    restart of at most ``MAX_ROWS``."""
    return (_graphed(rhs, params, precond) and rhs.dtype == torch.float32
            and params.restart <= MAX_ROWS)


class CoarseSolve:
    """The V-cycle's coarse GCR, run one restart cycle at a time, the host
    reading one device flag per cycle and nothing else; only x is kept.

    Where ``_graphed`` (CUDA fields at the coarsest level, restart mode, no
    other rank), the first solve runs eagerly, and then the two shapes of a
    cycle are captured as CUDA graphs in one private memory pool: the
    solve's opening and first cycle, and a later cycle. A restart cycle
    then always takes the same host-side path, so later solves copy their
    right-hand side into the graphs' input and replay, and prolongation
    reads the graphs' x. On float32 fields there the cycles run through the
    coarse GCR kernels (``KernelCycle``); elsewhere (CPU tensors, a coarse
    preconditioner, truncation, the replicated levels of the sharded MG,
    float64 fields, a restart past ``MAX_ROWS``) the generic loop
    (``GenericLoop.cycle``) runs them, eagerly but where graphed. The MG
    apply passes neither a communicator nor a left preconditioner. The
    graphs, their pool and their tensors belong to one hierarchy level, and
    go with it."""

    def __init__(self):
        self.graphs = None  # ((first, later), the captured loop, launches of each, counters)

    def solve(self, a, rhs, params, precond=None) -> dict:
        """The solve's device state: x, it, hist, going (and, from the
        generic loop, the rest of ``GenericLoop.STATE``)."""
        if self.graphs is not None:
            return self._replay(rhs, params)
        loop = self._loop(a, rhs, params, precond)
        self._drive(loop.cycle, loop.cycle, lambda: loop.state["going"], loop.check_every,
                    params.max_iter, self._counters(loop, "eager_cycles"))
        if _graphed(rhs, params, precond):
            self._capture(self._loop(a, cplx.CF(rhs.re.clone(), rhs.im.clone()), params, None))
        return loop.state

    @staticmethod
    def _loop(a, rhs, params, precond):
        if _kernel_cycles(rhs, params, precond):
            return KernelCycle(a, rhs, params)
        return GenericLoop(a, rhs, params, precond)

    @staticmethod
    def _counters(loop, kind: str) -> tuple[str, ...]:
        return (kind, "kernel_cycles") if isinstance(loop, KernelCycle) else (kind,)

    @staticmethod
    def _drive(first, later, going, n: int, max_iter: int, counters: tuple[str, ...]) -> None:
        first()
        done = n
        for c in counters:
            _CYCLES[c] += 1
        while done < max_iter and bool(going()):
            later()
            done += n
            for c in counters:
                _CYCLES[c] += 1

    def _capture(self, loop) -> None:
        """Capture the first and the later cycle of ``loop``, a fresh loop on
        a copy of the right-hand side, which the graphs keep: its tensors
        are the graphs' input, state and work space. Capturing runs no
        kernel, so the launches the wrappers counted meanwhile are taken
        back, and each replay credits its graph's."""
        graphs, launches = [], []
        for _ in range(2):
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(graph, pool=graphs[0].pool() if graphs else None):
                loop.cycle()
            after = launch_counts()
            launches.append({k: n - before[k] for k, n in after.items()})
            credit_launches({k: -n for k, n in launches[-1].items()})
            graphs.append(graph)
            _CYCLES["captures"] += 1
        self.graphs = (graphs, loop, launches, self._counters(loop, "replays"))

    def _replay(self, rhs, params) -> dict:
        (first, later), loop, (n_first, n_later), counters = self.graphs
        state = loop.state
        loop.rhs.re.copy_(rhs.re)
        loop.rhs.im.copy_(rhs.im)

        def run(graph, n):
            graph.replay()
            credit_launches(n)

        self._drive(lambda: run(first, n_first), lambda: run(later, n_later),
                    lambda: state["going"], params.restart, params.max_iter, counters)
        return state


@dataclasses.dataclass(frozen=True)
class MGPreconditioner(LinearOperator):
    a: LinearOperator  # fine operator
    q_field: cplx.CF | None  # (ne, 4, 3, T, Z, Y*X) per-block orthonormal basis ("tpu")
    coarse: LinearOperator  # Galerkin coarse operator: dense, block-ELL or block stencil
    block_map: BlockMap
    params: MGParams
    # cheaper operator for the smoother solves only (e.g. bf16 links,
    # ops/wilson_slab.with_link_dtype); the outer residual uses ``a``
    a_smooth: LinearOperator | None = None
    q: cplx.CF | None = None  # (ne, nb, block_len) blocked basis ("flat")
    layout: str = "tpu"  # "tpu": slab CF fields; "flat": canonical flat CF fields
    coarse_precond: "MGPreconditioner | None" = None  # the next level (n_level > 2)
    # the coarse GCR's restart cycles, and their CUDA graphs once captured
    coarse_solve: CoarseSolve = dataclasses.field(
        default_factory=CoarseSolve, init=False, repr=False, compare=False)

    @property
    def shape(self) -> tuple[int, int]:
        return self.a.shape

    def restrict(self, x):
        """R x = P^H x: fine field -> coarse (nb*ne,) CF."""
        basis = self.q_field if self.layout == "tpu" else self.q
        return _restrict_any(basis, self.block_map, x, self.layout)

    def prolong(self, xc, base=None, damping: float = 1.0):
        """base + damping * P xc (base None: 0); one pass on the slab layout."""
        if self.layout == "tpu":
            return transfer.prolong(self.q_field, self.block_map, xc, base, damping)
        out = prolong(self.q, self.block_map, xc, "flat")
        if damping != 1.0:
            out = cplx.scale_real(out, damping)
        return out if base is None else base + out

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
        """n smoother sweeps, each under the profiler span ``mg.smooth`` and
        counted by ``smoother_counts``."""
        a = self.a_smooth if self.a_smooth is not None else self.a
        if self.params.smoother == "neumann":
            for i in range(n):
                with annotate("mg.smooth"):
                    x = self._neumann_smooth(a, rhs, x, x_is_zero and i == 0)
                _SMOOTH["calls"] += 1
                _SMOOTH["iterations"] += self.params.smoother_terms
            return x
        sp = self.params.smoother_gcr
        if sp is None:
            return x
        for i in range(n):
            # from x = 0 the solver starts at r = rhs; a warm start
            # computes r = rhs - A x in the solver's own first apply
            with annotate("mg.smooth"):
                res = (gcr_solve(a, rhs, sp) if x_is_zero and i == 0
                       else gcr_solve(a, rhs, sp, x0=x))
            x = res.x
            _SMOOTH["calls"] += 1
            _SMOOTH["iterations"] += res.n_iters
        return x

    def apply(self, r):
        """One V(pre, post)-cycle approximating A^{-1} r (smoother on), or
        the additive deflation M = I + P C^-1 P^H (smoother off); the coarse
        GCR takes the next level's apply as its preconditioner."""

        def coarse_correct(res, base):
            cp = self.coarse_precond.apply if self.coarse_precond is not None else None
            rc, cg = self.restrict(res), self.params.coarse_gcr
            if cg.fused:
                ec = gcr_solve(self.coarse, rc, cg, precond=cp).x
            else:
                ec = self.coarse_solve.solve(self.coarse, rc, cg, cp)["x"]
            return self.prolong(ec, base=base, damping=self.params.correction_damping)

        if not self._has_smoother:
            return coarse_correct(r, r)
        x = self._smooth(r, cplx.zeros_like(r), self.params.n_pre_smooth, x_is_zero=True)
        x = coarse_correct(r - self.a.apply(x), x)
        return self._smooth(r, x, self.params.n_post_smooth)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------
def chiral_double(vecs: cplx.CF, mesh: LatticeMesh | None = None, layout: str = "tpu",
                  gamma5_fn=None) -> cplx.CF:
    """(n, ...) -> (2n, ...): [P_+ v_i ...; P_- v_i ...] with
    P_+- = (1 +- gamma_5) / 2 (MG.h:317-345); gamma_5 is ``gamma5_fn``, or
    that of the layout's fine fields."""
    if gamma5_fn is not None:
        g5 = gamma5_fn(vecs)
    elif layout == "tpu":
        g5 = gamma5_slab(vecs)
    else:
        g5 = fields.gamma5(vecs, mesh)
    return cplx.concatenate(
        [cplx.scale_real(vecs + g5, 0.5), cplx.scale_real(vecs - g5, 0.5)], axis=0
    )


def coarse_gamma5_fn(ne: int):
    """gamma_5 on a coarse level: the chirally doubled basis orders each
    block's dof as [ne/2 plus-chirality | ne/2 minus] (orthonormalisation
    never mixes the two subspaces), so coarse gamma_5 is the sign pattern
    diag(+1..., -1...) per block."""
    sign = np.ones(ne)
    sign[ne // 2:] = -1.0

    def g5(x):
        s = torch.as_tensor(sign, dtype=x.dtype, device=x.device)
        blocked = x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // ne, ne))
        return cplx.scale_real(blocked, s).reshape(x.shape)

    return g5


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


def block_orthonormalize(vecs: cplx.CF, block_map: BlockMap, layout: str = "tpu") -> cplx.CF:
    """Per-block orthonormal basis (ne, nb, block_len) of (ne, ...) fine
    vectors in ``layout``; replaces the reference's serial per-block
    Gram--Schmidt (MG.h:190-198) with the same column span (the JAX
    package's complex path takes a QR instead, of the same span)."""
    blocked = _to_blocked(block_map, vecs, layout)
    if blocked.shape[2] < blocked.shape[0]:
        raise ValueError("block_len smaller than number of coarse vectors")
    return _batched_mgs(blocked)


def field_basis(q: cplx.CF, block_map: BlockMap) -> cplx.CF:
    """Blocked basis (ne, nb, bl) -> field-shaped (ne, 4, 3, T, Z, Y*X)."""
    return block_map.from_blocked_tpu(q).contiguous()


def _column_fn(basis: cplx.CF, block_map: BlockMap, layout: str):
    """(e, w) -> the fine field with basis column e of every block b, weighted
    by the complex w[b]: the probe vector of both assemblies."""
    if layout == "tpu":
        site_blocks = torch.as_tensor(block_map.site_blocks(), device=basis.device)
        return lambda e, w: basis[e] * w[site_blocks]
    return lambda e, w: block_map.from_blocked(basis[e] * w[:, None])


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


def galerkin_coarse_blocks(a, basis: cplx.CF, block_map: BlockMap, layout: str = "tpu",
                           grid_bpd=None, block_offset=None):
    """Phase-probed Galerkin assembly: (nb, 2*ndim+1, ne, ne) complex stencil
    blocks and the neighbour table, from (2*ndim+1) x ne operator
    applications whatever the block count. ``basis`` is the layout's basis:
    q_field ("tpu") or the blocked q ("flat"). Each probe activates every
    block's basis column e at once, modulated by chi_p(B) = prod_mu
    omega_mu^(p_mu B_mu), applies A and restricts; columns go one at a
    time, so the transient is two fields.

    On one shard of a decomposed lattice (``solvers/mg_dist.py``) ``a`` is
    the shard's operator, ``block_map`` the shard's blocking, ``grid_bpd``
    the global blocks per dim and ``block_offset`` the global coordinates of
    the shard's first block: the phases are taken at global block
    coordinates, and the rows are the shard's blocks."""
    ne = basis.shape[0]
    nb = block_map.n_blocks
    bpd_loc = block_map.blocks_per_dim
    bpd = bpd_loc if grid_bpd is None else tuple(grid_bpd)
    offset = (0,) * len(bpd) if block_offset is None else tuple(block_offset)
    dev = basis.device
    cdt = cplx.complex_dtype(basis.dtype)
    column = _column_fn(basis, block_map, layout)

    def measure(p):
        """M_p[r; f, e] = sum_b chi_p(B_b) <phi_{r,f}, A phi_{b,e}>, un-phased
        by conj(chi_p(B_r)): (nb, ne_row, ne_col)."""
        grids = np.indices(bpd_loc)
        theta = sum(2.0 * np.pi * p[mu] * (grids[mu] + offset[mu]) / bpd[mu]
                    for mu in range(len(bpd)))
        chi = torch.as_tensor(np.exp(1j * np.asarray(theta, np.float64)).reshape(-1)).to(dev, cdt)
        cols = []
        for e in range(ne):
            rc = _restrict_any(basis, block_map, a.apply(column(e, chi)), layout)
            cols.append(torch.complex(rc.re, rc.im).reshape(nb, ne))
        rbb = torch.stack(cols) * chi.conj()[None, :, None]  # (e_col, nb, f_row)
        return rbb.permute(1, 2, 0)

    slots = stencil_from_probes(measure, bpd)
    return torch.stack(slots, dim=1), block_map.neighbor_table()


def galerkin_coarse_matrix(a, basis: cplx.CF, block_map: BlockMap, layout: str = "flat"):
    """Dense Galerkin coarse matrix C = P^H A P (nc, nc), complex, by a sweep
    over block columns: the ne basis vectors of block b go through A one at
    a time and restrict against every block's basis. No stencil-locality
    assumption; nb x ne operator applications. ``basis`` as in
    :func:`galerkin_coarse_blocks`."""
    ne = basis.shape[0]
    nb = block_map.n_blocks
    column = _column_fn(basis, block_map, layout)
    cdt = cplx.complex_dtype(basis.dtype)
    cols = []
    for b in range(nb):
        w = torch.zeros(nb, dtype=cdt, device=basis.device)
        w[b] = 1.0
        for e in range(ne):
            rc = _restrict_any(basis, block_map, a.apply(column(e, w)), layout)
            cols.append(torch.complex(rc.re, rc.im))
    return torch.stack(cols, dim=1)  # column b * ne + e


def blocks_to_dense(blocks: torch.Tensor, table) -> torch.Tensor:
    """(nb, K, ne, ne) stencil blocks -> dense Galerkin matrix (nc, nc)."""
    return BlockSparseOperator(blocks, table).to_dense()


def coarse_to_block_ell(c: torch.Tensor, block_map: BlockMap, ne: int) -> BlockSparseOperator:
    """The 9-point block structure of a dense Galerkin matrix in block-ELL
    form (the reference's HierarchicalSparse layout, HierarchicalSparse.h:
    22-48); a slot whose block column an earlier slot of its row already
    holds (short block extents) is zeroed, so each coupling counts once."""
    tab = block_map.neighbor_table()
    nb = tab.shape[0]
    per_block = c.reshape(nb, ne, nb, ne).permute(0, 2, 1, 3)
    table = torch.as_tensor(tab, dtype=torch.long, device=c.device)
    blocks = per_block[torch.arange(nb, device=c.device)[:, None], table]  # (nb, K, ne, ne)
    k = tab.shape[1]
    dup = (tab[:, :, None] == tab[:, None, :]) & (np.arange(k)[None, :, None] > np.arange(k)[None, None, :])
    mask = torch.as_tensor(dup.any(axis=2), device=c.device)[:, :, None, None]
    return BlockSparseOperator(torch.where(mask, torch.zeros_like(blocks), blocks), tab)


def build_coarse_operator(blocks, table, coarse_format: str, bpd) -> LinearOperator:
    """The coarse operator in ``coarse_format`` from the phase-probed stencil
    blocks (nb, K, ne, ne) and their neighbour table: "dense"
    (``DenseOperator``), "bsr" (``BlockSparseOperator``) or "stencil"
    (``StencilBlockOperator`` over the block grid ``bpd``, kernel B12 on the
    card). The three agree: duplicate +-mu slots on short block extents
    hold zero blocks."""
    if coarse_format == "stencil":
        return StencilBlockOperator(blocks, tuple(int(b) for b in bpd))
    if coarse_format == "bsr":
        return BlockSparseOperator(blocks, table)
    if coarse_format == "dense":
        return DenseOperator(blocks_to_dense(blocks, table))
    raise ValueError(f"coarse_format must be one of {_FORMATS}, not {coarse_format!r}")


def _check_params(params: MGParams) -> None:
    if params.coarse_format not in _FORMATS:
        raise ValueError(f"coarse_format must be one of {_FORMATS}, not {params.coarse_format!r}")
    if params.assembly == "columns" and params.coarse_format == "stencil":
        raise ValueError(
            "coarse_format='stencil' requires the phase-probed assembly (assembly='phased')"
        )


def _check_transfer_backend(params: MGParams, device) -> None:
    """The port has one transfer route, "auto": the kernels for CUDA
    tensors, their plain versions for CPU tensors. Any other value of the
    JAX field names a route the port does not have on the card."""
    if params.transfer_backend != "auto" and torch.device(device).type == "cuda":
        raise ValueError(
            f"transfer_backend={params.transfer_backend!r}: on CUDA tensors the port "
            "runs the transfer kernels; use 'auto'"
        )


def _field_spec(a, mesh: LatticeMesh, layout: str):
    """(field shape, real dtype, device) of the fine operator's fields."""
    d = getattr(a, "d", a)
    shape = d.field_shape if layout == "tpu" else (mesh.size,)
    return shape, d.dtype, d.device


def setup_mg(
    generator: torch.Generator,
    a: LinearOperator,
    mesh: LatticeMesh,
    params: MGParams,
    smoother_operator: LinearOperator | None = None,
    timings: dict | None = None,
    layout: str = "tpu",
    gamma5_fn=None,
) -> MGPreconditioner:
    """Adaptive-MG setup (MG::initialise, MG.h:132-285), recursive for
    ``params.n_level > 2``. Each level's start vector is drawn from
    ``generator`` (which lives on the operator's device) when that level is
    set up; :func:`setup_mg_from` takes them explicitly."""

    def draw(level, shape, rdt, dev):
        return cplx.random(generator, shape, rdt, device=dev)

    return _setup_level(draw, a, mesh, params, 1, layout, gamma5_fn, smoother_operator, timings)


def setup_mg_from(
    b0,
    a: LinearOperator,
    mesh: LatticeMesh,
    params: MGParams,
    smoother_operator: LinearOperator | None = None,
    timings: dict | None = None,
    layout: str = "tpu",
    gamma5_fn=None,
) -> MGPreconditioner:
    """:func:`setup_mg` from explicit start vectors: ``b0`` is level 1's, or
    a sequence with one per level, level 1 first (levels >= 2 take flat
    (nb * ne,) CFs of the level above). ``timings``, when given, receives
    the wall seconds of each phase (power, orthonormalise, galerkin,
    coarse_operator, coarse_levels), the device synchronised at each phase
    end."""
    starts = list(b0) if isinstance(b0, (list, tuple)) else [b0]

    def draw(level, shape, rdt, dev):
        if level > len(starts):
            raise ValueError(f"no start vector for level {level} of {params.n_level}")
        return starts[level - 1]

    return _setup_level(draw, a, mesh, params, 1, layout, gamma5_fn, smoother_operator, timings)


def _setup_level(draw, a, mesh, params, level, layout, gamma5_fn, smoother_operator,
                 timings) -> MGPreconditioner:
    _check_params(params)
    shape, rdt, dev = _field_spec(a, mesh, layout)
    _check_transfer_backend(params, dev)
    b0 = draw(level, shape, rdt, dev)
    sync = torch.cuda.synchronize if b0.device.type == "cuda" else (lambda *_: None)
    clock = [time.perf_counter()]

    def phase(name):
        if timings is not None and level == 1:
            sync(b0.device)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    vecs = inverse_power_vectors(
        a, b0, params.n_nullvecs, params.setup_gcr, params.setup_power_iters
    )
    phase("power")
    block_map = mesh.blocking(params.block if level == 1 else params.coarse_block)
    q = block_orthonormalize(chiral_double(vecs, mesh, layout, gamma5_fn), block_map, layout)
    del vecs
    q_field = None
    if layout == "tpu":  # the slab layout keeps the field-shaped basis only
        q_field, q = field_basis(q, block_map), None
    basis = q_field if layout == "tpu" else q
    phase("orthonormalise")
    ne = basis.shape[0]
    if params.assembly == "phased":
        blocks, table = galerkin_coarse_blocks(a, basis, block_map, layout)
        phase("galerkin")
        coarse = build_coarse_operator(blocks, table, params.coarse_format,
                                       block_map.blocks_per_dim)
        del blocks
    else:  # per-block-column sweep: no stencil-locality assumption
        c = galerkin_coarse_matrix(a, basis, block_map, layout)
        phase("galerkin")
        coarse = (coarse_to_block_ell(c, block_map, ne) if params.coarse_format == "bsr"
                  else DenseOperator(c))
    phase("coarse_operator")

    coarse_precond = None
    bpd, cb = block_map.blocks_per_dim, params.coarse_block
    if params.n_level - level > 1 and all(d % cb == 0 and d >= cb for d in bpd) and (
        cb**4 * ne >= 2 * params.n_nullvecs
    ):
        coarse_precond = _setup_level(
            draw, coarse, LatticeMesh((*bpd, ne), n_spacetime=4), params, level + 1, "flat",
            coarse_gamma5_fn(ne), None, None,
        )
    phase("coarse_levels")
    if q_field is not None and params.transfer_dtype is not None:
        q_field = q_field.astype(_STORAGE[params.transfer_dtype])
    return MGPreconditioner(a, q_field, coarse, block_map, params, smoother_operator, q,
                            layout, coarse_precond)


def _complex_np(z):
    """A complex ndarray, or an (re, im) pair of ndarrays, as one ndarray."""
    return z[0] + 1j * np.asarray(z[1]) if isinstance(z, (tuple, list)) else np.asarray(z)


def _coarse_from_numpy(coarse, params: MGParams, block_map: BlockMap, rdt, dev):
    cdt = cplx.complex_dtype(rdt)
    if params.coarse_format == "dense":
        return DenseOperator(torch.as_tensor(_complex_np(coarse)).to(dev, cdt))
    blocks, cols_or_dims = coarse
    if params.coarse_format == "bsr":
        return BlockSparseOperator(torch.as_tensor(np.asarray(blocks)).to(dev, cdt),
                                   torch.as_tensor(np.array(cols_or_dims)))
    if tuple(cols_or_dims) != block_map.blocks_per_dim:
        raise ValueError(f"stencil dims {tuple(cols_or_dims)} are not the block grid "
                         f"{block_map.blocks_per_dim}")
    return StencilBlockOperator(cplx.from_numpy(blocks, rdt, dev), tuple(cols_or_dims))


def mg_from_numpy(
    a: LinearOperator,
    mesh: LatticeMesh,
    q_field,
    coarse,
    params: MGParams,
    a_smooth: LinearOperator | None = None,
    device=None,
    coarse_levels=(),
) -> MGPreconditioner:
    """The JAX package's MG hierarchy -> the port's ``MGPreconditioner`` on
    ``device`` (CUDA unless named), in the slab layout.

    ``q_field``: the field-shaped basis (ne, 4, 3, T, Z, Y*X); ``coarse``:
    the coarse operator of ``params.coarse_format`` ("dense": the (nc, nc)
    matrix; "bsr": the pair (blocks, block_cols); "stencil": the pair
    (blocks, dims), blocks (nb, K, ne, ne)); the block extent is
    ``params.block``. ``coarse_levels``: one pair (q, coarse) per further
    level, q the blocked basis (ne, nb, block_len) of the flat level and
    coarse as above; its block extent is ``params.coarse_block``. Arrays are
    complex ndarrays or (re, im) pairs of ndarrays (not the pairs above).
    Fields and operators are stored in the operator's field dtype; the slab
    basis in ``params.transfer_dtype`` when that is set."""
    dev = cplx.resolve_device(device)
    _check_transfer_backend(params, dev)
    _, rdt, _ = _field_spec(a, mesh, "tpu")
    qf = cplx.from_numpy(_complex_np(q_field), rdt, dev)
    if params.transfer_dtype is not None:
        qf = qf.astype(_STORAGE[params.transfer_dtype])

    def level(fine, block_map, q_field_l, q_l, layout, coarse_l, rest, smooth):
        op = _coarse_from_numpy(coarse_l, params, block_map, rdt, dev)
        below = None
        if rest:
            ne = (q_field_l if layout == "tpu" else q_l).shape[0]
            cmesh = LatticeMesh((*block_map.blocks_per_dim, ne), n_spacetime=4)
            q2, coarse2 = rest[0]
            below = level(op, cmesh.blocking(params.coarse_block), None,
                          cplx.from_numpy(_complex_np(q2), rdt, dev), "flat", coarse2, rest[1:],
                          None)
        return MGPreconditioner(fine, q_field_l, op, block_map, params, smooth, q_l, layout, below)

    return level(a, mesh.blocking(params.block), qf, None, "tpu", coarse, list(coarse_levels),
                 a_smooth)
