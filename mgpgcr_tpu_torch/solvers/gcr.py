"""Flexible GCR (Generalised Conjugate Residual) Krylov solver.

Counterpart of ``mgpgcr_tpu/solvers/gcr.py`` (the reference's
``GCR<T>::solve``, GCR.h:159-302). JAX's ``lax.while_loop`` becomes a
Python loop over device tensors. Every scalar of the recurrence (alpha,
the betas, the norms, the iteration count, the residual history) stays on
the device: the loop asks the host whether to go on only once per restart
cycle (every ``_CHECK_EVERY`` iterations without restart), and an
iteration run past convergence is masked to a no-op on the device (alpha
is zeroed, the count and history freeze), exactly where the reference's
``while_loop`` would have stopped. Iteration counts and histories
therefore equal the reference's.

Semantics kept from the reference (and from the JAX package):
- restart XOR truncation direction management (GCR.h:162-186, 277-287);
- stopping on ||r||^2 / ||rhs||^2 <= tol^2 (GCR.h:288), history recorded
  every iteration (GCR.h:270-274);
- flexible right preconditioning z = M(r); left preconditioning by
  transforming A and rhs; alpha = <Ap, r> / <Ap, Ap>; x0 = 0 by default.

Forms: the generic loop (``gcr_solve`` with ``fused=False``) on any
operator; and, through the hand-written kernels, the restart-cycle z-basis
form (``_gcr_solve_fused_cycles``) and the loop form on direction stacks
(``_gcr_solve_fused``: truncation, ``residual_refresh``, restart > 16,
``unroll="loop"``, and a preconditioner under ``unroll="auto"``), chosen
as the JAX package chooses. ``gcr_solve_eager`` runs the generic loop or
the fused loop form in their eager mode: no masking, convergence read
every ``check_every`` iterations, the eager history layout.

With a communicator ``comm`` (``parallel/comm.py``) the solve is one
rank's part of a domain-decomposed solve (the JAX package's
``axis_names`` inside ``shard_map``): fields and the operator are this
rank's shards, and every reduction is summed over ranks (``_allsum``) at
the points where the JAX package ``psum``s it, before any division.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step, gcr_z_step
from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import gcr_stream_step_local
from mgpgcr_tpu_torch.kernels.gcr_kernels import (
    ap_update,
    basis_flush,
    beta_dots,
    dir_update,
    update_r,
    update_xr,
)
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.dirac import DiracOperator
from mgpgcr_tpu_torch.ops.dslash import CudaWilsonDirac
from mgpgcr_tpu_torch.ops.dslash_dist import ShardLocalWilsonDirac
from mgpgcr_tpu_torch.solvers.params import GCRParams
from mgpgcr_tpu_torch.solvers.result import SolveResult

Preconditioner = Callable

# host convergence check interval of the generic loop without restart
_CHECK_EVERY = 10


def _tiny(rdtype) -> float:
    return 1e-300 if rdtype == torch.float64 else 1e-30


def _div_real(num, den, rdtype):
    """num / den for complex num and real den, guarded against 0 (the
    reference's multiply-by-reciprocal form)."""
    return num * (1.0 / torch.clamp(den, min=_tiny(rdtype)))


def _allsum(v, comm):
    """The sum over ranks of a per-shard partial; v itself without a
    communicator."""
    return v if comm is None else comm.allsum(v)


def _running(r2, rhs_norm2, tol2: float, it, max_iter: int):
    """The reference's loop condition, as a device bool."""
    return (r2 > tol2 * rhs_norm2) & (it < max_iter)


def _record(hist, it, active, r2, rhs_norm2, rdtype) -> None:
    """hist[it] = relres where active, on the device."""
    idx = it.reshape(1)
    rel = torch.sqrt(r2 / torch.clamp(rhs_norm2, min=_tiny(rdtype))).reshape(1)
    hist.index_put_((idx,), torch.where(active, rel, hist.index_select(0, idx)))


def _result(x, r2, rhs_norm2, tol2, it, hist, rdtype) -> SolveResult:
    final = torch.sqrt(r2 / torch.clamp(rhs_norm2, min=_tiny(rdtype)))
    return SolveResult(
        x=x,
        converged=bool(r2 <= tol2 * rhs_norm2),
        n_iters=int(it),
        final_relres=float(final),
        res_history=hist,
    )


def gcr_solve(
    a,
    rhs,
    params: GCRParams,
    precond: Optional[Preconditioner] = None,
    x0=None,
    fused: bool | None = None,
    left_precond: Optional[Preconditioner] = None,
    comm=None,
) -> SolveResult:
    """Solve A x = rhs with flexible GCR; fields are ``cplx.CF``.

    ``precond`` is the flexible RIGHT preconditioner, ``left_precond`` the
    LEFT one (GCR then runs on L A and L rhs, and the history is measured
    in the L-preconditioned norm). ``fused`` (default ``params.fused``)
    runs the iteration through the hand-written kernels: the restart-cycle
    form where ``params`` allow it, else the loop form. ``comm`` makes the
    solve one rank's part of a domain-decomposed solve (module docstring);
    every rank must call it together."""
    if left_precond is not None:
        base_apply = a.apply if hasattr(a, "apply") else a
        a = lambda v: left_precond(base_apply(v))  # noqa: E731
        rhs = left_precond(rhs)
    if fused is None:
        fused = params.fused
    if not fused:
        return _gcr_solve_generic(a, rhs, params, precond, x0, comm=comm)
    unroll_ok = params.unroll == "cycles" or (params.unroll == "auto" and precond is None)
    if params.restart and params.restart <= 16 and not params.residual_refresh and unroll_ok:
        return _gcr_solve_fused_cycles(a, rhs, params, precond, x0, comm)
    return _gcr_solve_fused(a, rhs, params, precond, x0, comm=comm)


def _gcr_solve_generic(a, rhs, params: GCRParams, precond, x0, eager: bool = False, comm=None):
    """The generic loop on stacks of ``storage_size`` directions (reference
    GCR.h:222-288). ``eager`` gives ``gcr_solve_eager``'s semantics: the
    host reads ||r||^2 every iteration (so no iteration is masked), the
    solve stops before an iteration whose ||ap||^2 is 0 (z in the span of
    the stored directions), residual_refresh is ignored and the history
    has ``n_iters + 1`` entries."""
    apply_a = a.apply if hasattr(a, "apply") else a
    rdtype, dev = rhs.dtype, rhs.device
    S = params.storage_size
    max_iter = params.max_iter
    restart = params.restart if params.restart else max_iter + 1

    x = cplx.zeros_like(rhs) if x0 is None else x0
    r = rhs - apply_a(x) if x0 is not None else rhs
    rhs_norm2 = _allsum(cplx.abs2_sum(rhs), comm)

    z = precond(r) if precond is not None else r
    p = z
    ap = apply_a(p)
    ps = cplx.stack_zeros(S, p)
    ps[0] = p
    aps = cplx.stack_zeros(S, ap)
    aps[0] = ap
    ap2 = _allsum(cplx.abs2_sum(ap), comm)
    ap_norms = torch.zeros(S, dtype=rdtype, device=dev)
    ap_norms[0] = ap2

    r2 = _allsum(cplx.abs2_sum(r), comm)
    hist = torch.full((max_iter + 1,), float("nan"), dtype=rdtype, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    _record(hist, it, torch.ones((), dtype=torch.bool, device=dev), r2, rhs_norm2, rdtype)
    tol2 = params.tol**2
    check_every = 1 if eager else (params.restart or _CHECK_EVERY)
    refresh = 0 if eager else params.residual_refresh

    count = n_body = 0  # iterations since the last restart, and bodies run
    going = bool(_running(r2, rhs_norm2, tol2, it, max_iter))
    while going:
        if eager and float(ap2) == 0.0:
            break  # stagnation: z in the span of the stored directions
        n_body += 1
        active = _running(r2, rhs_norm2, tol2, it, max_iter)
        it = it + active
        count += 1

        alpha = _div_real(_allsum(cplx.vdot(ap, r), comm), ap2, rdtype) * active.to(rdtype)
        x = x + p * alpha
        r = r - ap * alpha
        if refresh and n_body % refresh == 0:
            r = cplx.where(active, rhs - apply_a(x), r)
        r2 = _allsum(cplx.abs2_sum(r), comm)
        _record(hist, it, active, r2, rhs_norm2, rdtype)
        if n_body % check_every == 0 or n_body == max_iter:
            going = bool(_running(r2, rhs_norm2, tol2, it, max_iter))
            if not going:
                break  # the next direction would not be used

        z = precond(r) if precond is not None else r
        az = apply_a(z)
        # beta_j = <Ap_j, Az> / ||Ap_j||^2, zero where the slot is empty
        raw = _allsum(cplx.conj_contract_stack(aps, az), comm)
        betas = torch.where(
            ap_norms > 0, _div_real(raw, ap_norms, rdtype), torch.zeros_like(raw)
        )
        p = z - cplx.weighted_stack_sum(betas, ps)
        ap = az - cplx.weighted_stack_sum(betas, aps)

        # restart retires the stored directions (GCR.h:277-283): only the
        # norms are cleared; stale rows are never read (betas masked)
        if count % restart == 0:
            count = 0
            ap_norms = torch.zeros_like(ap_norms)
        slot = count % S  # ring slot (GCR.h:286-287)
        ps[slot] = p
        aps[slot] = ap
        ap2 = _allsum(cplx.abs2_sum(ap), comm)
        ap_norms[slot] = ap2

    return _result(x, r2, rhs_norm2, tol2, it, hist[: n_body + 1] if eager else hist, rdtype)


def _gcr_solve_fused(a, rhs, params: GCRParams, precond, x0, check_every: int = 0,
                     eager: bool = False, comm=None) -> SolveResult:
    """The fused loop form on the direction stacks ps and aps (JAX
    ``_gcr_solve_fused``, reference loop GCR.h:222-288): truncation,
    residual_refresh, restart > 16, ``unroll="loop"``, and a preconditioner
    under ``unroll="auto"``.

    One iteration without a preconditioner: update_xr (B6: x += alpha p,
    r -= alpha ap, ||r||^2), A z, beta_dots (B3) and dir_update (B7: p and
    ap into the ring slot in place, ||ap||^2 and <ap, r> dotted against z,
    which is r). With a right preconditioner on ``CudaWilsonDirac`` with an
    even t extent: B6, z = M(r), the z-step (B9: A z and the dots) and B7,
    whose dot is discarded for the recursion <ap_new, r> = <az, r> -
    sum conj(beta_j) <ap_j, r>. With any other operator: B6, M(r), A z, B3
    and B7 dotted against r. The host asks whether to go on every
    ``check_every`` iterations (default: every iteration with a
    preconditioner, whose apply outweighs the wait, else every ``restart``
    or ``_CHECK_EVERY``), right after B6, and an iteration past convergence
    is masked on the device as in the generic loop. count, slot and the
    live prefix lim = clip(count, 1, S) do not depend on the data, so they
    are host ints.

    ``eager`` gives the fused ``gcr_solve_eager`` (JAX
    ``_gcr_solve_eager_fused``): no z-step (B6, M(r), A z, B3, B7), no
    masking, so up to ``check_every - 1`` iterations run and count past
    convergence, a stop at a check where ||ap||^2 is 0, and a history of
    ``n_iters + 1`` entries."""
    apply_a = a.apply if hasattr(a, "apply") else a
    rdtype, dev = rhs.dtype, rhs.device
    S = params.storage_size
    max_iter = params.max_iter
    restart = params.restart if params.restart else max_iter + 1
    zstep = _z_step_config(a) if precond is not None and not eager else None
    dot_r = precond is not None and zstep is None  # B7 dots against r, not z

    x = cplx.zeros_like(rhs) if x0 is None else x0
    r = rhs - apply_a(x) if x0 is not None else rhs
    rhs_norm2 = _allsum(cplx.abs2_sum(rhs), comm)

    z = precond(r) if precond is not None else r
    ap = apply_a(z)
    ps = cplx.stack_zeros(S, z)
    ps[0] = z
    aps = cplx.stack_zeros(S, ap)
    aps[0] = ap
    ap2 = _allsum(cplx.abs2_sum(ap), comm)
    ap_norms = torch.zeros(S, dtype=rdtype, device=dev)
    ap_norms[0] = ap2
    apr = _allsum(cplx.vdot(ap, r), comm)

    r2 = _allsum(cplx.abs2_sum(r), comm)
    hist = torch.full((max_iter + 1,), float("nan"), dtype=rdtype, device=dev)
    always = torch.ones((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    _record(hist, it, always, r2, rhs_norm2, rdtype)
    tol2 = params.tol**2
    if not check_every:
        check_every = 1 if precond is not None else (params.restart or _CHECK_EVERY)

    count = slot = n_body = 0
    going = bool(_running(r2, rhs_norm2, tol2, it, max_iter))
    while going:
        n_body += 1
        active = always if eager else _running(r2, rhs_norm2, tol2, it, max_iter)
        it = it + active
        count += 1

        alpha = _div_real(apr, ap2, rdtype) * active.to(rdtype)
        x, r, r2_new = update_xr(x, r, ps, aps, slot, alpha)
        r2_new = _allsum(r2_new, comm)
        if params.residual_refresh and n_body % params.residual_refresh == 0:
            r = cplx.where(active, rhs - apply_a(x), r)
            r2_new = _allsum(cplx.abs2_sum(r), comm)
        r2 = torch.where(active, r2_new.to(rdtype), r2)
        _record(hist, it, active, r2, rhs_norm2, rdtype)
        if n_body % check_every == 0 or n_body == max_iter:
            going = bool(_running(r2, rhs_norm2, tol2, it, max_iter))
            if not going or (eager and float(ap2) == 0.0):
                break  # converged, out of iterations, or z in the stored span

        z = precond(r) if precond is not None else r
        lim = min(count, S)  # the live rows are the prefix [0:lim]
        if zstep is not None:
            az, raw, aprd = zstep(z, r, aps, lim)
            aprd = _allsum(aprd, comm)
        else:
            az = apply_a(z)
            raw = beta_dots(aps, az, lim)
        raw = _allsum(raw, comm)
        betas = torch.where(
            ap_norms > 0, _div_real(raw, ap_norms, rdtype), torch.zeros_like(raw)
        )
        if count % restart == 0:  # GCR.h:277-283, as in the generic loop
            count = 0
            ap_norms = torch.zeros_like(ap_norms)
        slot = count % S
        ps, aps, ap2, apr = dir_update(z, az, r if dot_r else None, ps, aps, betas, slot, lim)
        ap2 = _allsum(ap2, comm)
        if zstep is not None:
            apr = aprd[S] - torch.sum(betas[:lim].conj() * aprd[:lim])
        else:
            apr = _allsum(apr, comm)
        ap_norms[slot] = ap2

    return _result(x, r2, rhs_norm2, tol2, it, hist[: n_body + 1] if eager else hist, rdtype)


def _mega_step_config(a, precond):
    """Step function ``(r, aps, alpha, lim) -> (r', az, r2, raw, apr)`` when
    the one-pass GCR step applies: unpreconditioned A = I - kD with
    ``CudaWilsonDirac`` on t-major links as D, single device (the JAX
    package's ``_links_is_tmajor`` and tb/zb checks), or per shard with
    ``ShardLocalWilsonDirac`` as D and an even local t extent of at least
    2 (B15; its reductions are this shard's partials). None otherwise."""
    if precond is not None or not isinstance(a, DiracOperator):
        return None
    d = a.d
    if isinstance(d, ShardLocalWilsonDirac):
        t_loc = d.local_mesh.spacetime_dims[0]
        if t_loc < 2 or t_loc % 2:
            return None

        def step_dist(r, aps, alpha, lim):
            return gcr_stream_step_local(d.links, d.ghost_links, r, aps, alpha, a.k, lim,
                                         d.local_mesh, d.comm, d.axis_t, d.axis_z, d.anti_t)

        return step_dist
    if not isinstance(d, CudaWilsonDirac) or not d.t_major or d.mesh.spacetime_dims[0] < 2:
        return None

    def step(r, aps, alpha, lim):
        return gcr_stream_step(d.links, r, aps, alpha, a.k, lim, d.mesh, anti_t=d.anti_t)

    return step


def _z_step_config(a):
    """Step function ``(z, r, aps, lim) -> (az, raw, apr)`` when the
    preconditioned one-pass step applies: A = I - kD with
    ``CudaWilsonDirac`` on t-major links as D and an even t extent of at
    least 2, the conditions of the JAX package's ``_z_step_config``. None
    otherwise."""
    if not isinstance(a, DiracOperator):
        return None
    d = a.d
    t = d.mesh.spacetime_dims[0] if isinstance(d, CudaWilsonDirac) and d.t_major else 0
    if t < 2 or t % 2:
        return None

    def zstep(z, r, aps, lim):
        return gcr_z_step(d.links, z, r, aps, a.k, lim, d.mesh, anti_t=d.anti_t)

    return zstep


def _gcr_solve_fused_cycles(a, rhs, params: GCRParams, precond, x0, comm=None) -> SolveResult:
    """Restart-cycle fused GCR in the z-basis representation.

    The search directions p_j are never materialised: only A p_j lives in
    the stack (for the beta dots and the residual update), and each p_j's
    expansion over the cycle's basis [p0, z_1 .. z_R] is a triangular table
    of complex coefficients on the device. Per iteration without a
    preconditioner: one one-pass step (K2: r' = r - alpha Ap, az = A r',
    ||r'||^2 and the dots) and one ap_update (K3). With a right
    preconditioner M: update_r (B2: r' = r - alpha Ap, ||r'||^2), z = M(r'),
    the z-step (B9: az = A z and the dots) and ap_update. Per cycle one
    basis_flush (K4) gives x += sum alpha_j p_j and the next seed
    direction. <ap_new, r'> follows by recursion from the step's dots, so
    K3 never reads r. On operators without a one-pass step (another
    operator, an odd t extent): update_r, M(r) if preconditioned, A z,
    beta_dots (B3) and K3 in its r form, which dots <ap_new, r'>. Reference
    loop: GCR.h:222-288; JAX counterpart: ``_gcr_solve_fused_cycles``."""
    mega = _mega_step_config(a, precond)
    zstep = _z_step_config(a) if precond is not None else None
    apply_a = a.apply if hasattr(a, "apply") else a
    rdtype, dev = rhs.dtype, rhs.device
    cdt = cplx.complex_dtype(rdtype)
    S = params.storage_size
    R = params.restart
    max_iter = params.max_iter

    x = cplx.zeros_like(rhs) if x0 is None else x0
    r = rhs - apply_a(x) if x0 is not None else rhs
    rhs_norm2 = _allsum(cplx.abs2_sum(rhs), comm)

    p0 = precond(r) if precond is not None else r
    ap = apply_a(p0)
    aps = cplx.stack_zeros(S, ap)
    aps[0] = ap
    ap2 = _allsum(cplx.abs2_sum(ap), comm)
    ap_norms = torch.zeros(S, dtype=rdtype, device=dev)
    ap_norms[0] = ap2
    apr = _allsum(cplx.vdot(ap, r), comm)

    r2 = _allsum(cplx.abs2_sum(r), comm)
    hist = torch.full((max_iter + 1,), float("nan"), dtype=rdtype, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    _record(hist, it, torch.ones((), dtype=torch.bool, device=dev), r2, rhs_norm2, rdtype)
    tol2 = params.tol**2

    while bool(_running(r2, rhs_norm2, tol2, it, max_iter)):  # one sync per cycle
        basis = [p0]  # b_0 = seed direction, then b_j = z_j (= r_j unpreconditioned)
        coef = torch.zeros((R + 1, R + 1), dtype=cdt, device=dev)  # coef[j, m]
        coef[0, 0] = 1
        alphas = torch.zeros(R, dtype=cdt, device=dev)
        for j in range(R):
            # past convergence alpha masks to zero: x, r, it, hist freeze
            active = _running(r2, rhs_norm2, tol2, it, max_iter)
            alpha = _div_real(apr, ap2, rdtype) * active.to(rdtype)
            it = it + active
            alphas[j] = alpha

            if mega is not None:
                r, az, r2, raw, aprd = mega(r, aps, alpha, j + 1)
                raw, aprd = _allsum(raw, comm), _allsum(aprd, comm)
                z = r
            else:
                r, r2 = update_r(r, aps, j, alpha)
            r2 = _allsum(r2, comm)
            _record(hist, it, active, r2, rhs_norm2, rdtype)
            if mega is None:
                z = precond(r) if precond is not None else r
                if zstep is not None:
                    az, raw, aprd = zstep(z, r, aps, j + 1)
                    raw, aprd = _allsum(raw, comm), _allsum(aprd, comm)
                else:
                    az = apply_a(z)
                    raw = _allsum(beta_dots(aps, az, j + 1), comm)
            betas = torch.where(
                ap_norms > 0, _div_real(raw, ap_norms, rdtype), torch.zeros_like(raw)
            )

            # p_new = z - sum_i beta_i p_i, as coefficients over the basis
            basis.append(z)
            b = betas[: j + 1]
            coef[j + 1, : j + 1] = -(b @ coef[: j + 1, : j + 1])
            coef[j + 1, j + 1] = 1

            slot = 0 if j == R - 1 else j + 1
            if mega is not None or zstep is not None:
                # <ap_new, r'> = <az, r'> - sum conj(beta_i) <ap_i, r'>
                apr = aprd[S] - torch.sum(b.conj() * aprd[: j + 1])
                aps, ap2 = ap_update(az, aps, betas, slot, j + 1)
            else:
                aps, ap2, apr = ap_update(az, aps, betas, slot, j + 1, r=r)
                apr = _allsum(apr, comm)
            ap2 = _allsum(ap2, comm)
            ap_norms[slot] = ap2

        # x += sum_j alpha_j p_j and p0' = p_new, in one pass over the basis
        wx = alphas @ coef[:R]
        x, p0 = basis_flush(x, basis, wx, coef[R])

    return _result(x, r2, rhs_norm2, tol2, it, hist, rdtype)


@dataclasses.dataclass(frozen=True)
class GCRSolver:
    """Solver-as-operator: applying it approximates A^{-1} (the reference's
    composition idiom, GCR.h:62-68)."""

    a: LinearOperator
    params: GCRParams

    def solve(self, rhs, x0=None, precond=None, left_precond=None) -> SolveResult:
        return gcr_solve(
            self.a, rhs, self.params, precond=precond, x0=x0, left_precond=left_precond
        )

    def __call__(self, rhs):
        return self.solve(rhs).x

    def as_preconditioner(self) -> Preconditioner:
        return lambda r: self.solve(r).x


# PyTorch runs eagerly: the JAX package's jitted entry point is the solve
gcr_solve_jit = gcr_solve


def gcr_solve_eager(
    a,
    rhs,
    params: GCRParams,
    precond: Optional[Preconditioner] = None,
    x0=None,
    fused: bool | None = None,
    check_every: int = 1,
) -> SolveResult:
    """Host-driven GCR (JAX ``gcr_solve_eager``): the host reads the
    residual norm and decides after each checked iteration.

    Same mathematics as ``gcr_solve`` in restart or truncation mode. The
    generic form reads ||r||^2 every iteration and stops early on
    ||ap||^2 == 0 (z in the span of the stored directions); it ignores
    ``check_every`` and ``residual_refresh``, as the JAX package does.
    ``fused`` (default ``params.fused``; not with residual_refresh) runs
    each iteration through the loop form's kernels (update_xr, M r, A z,
    beta_dots, dir_update) and reads the norm only every ``check_every``
    iterations, so it may run up to ``check_every - 1`` iterations past
    convergence. Both are the loops of ``gcr_solve`` in their eager mode.
    The history has ``n_iters + 1`` entries, no NaN fill."""
    if fused is None:
        fused = params.fused
    if float(cplx.abs2_sum(rhs)) == 0.0:
        return SolveResult(x=cplx.zeros_like(rhs), converged=True, n_iters=0, final_relres=0.0,
                           res_history=torch.zeros(1, dtype=rhs.dtype, device=rhs.device))
    if fused and not params.residual_refresh:
        return _gcr_solve_fused(a, rhs, params, precond, x0, check_every, eager=True)
    return _gcr_solve_generic(a, rhs, params, precond, x0, eager=True)
