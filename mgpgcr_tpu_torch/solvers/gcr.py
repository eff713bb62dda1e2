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

Two forms: the generic loop (``gcr_solve`` with ``fused=False``) on any
operator, and the restart-cycle z-basis form through the hand-written
kernels (``_gcr_solve_fused_cycles``), unpreconditioned or with a right
preconditioner.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step, gcr_z_step
from mgpgcr_tpu_torch.kernels.gcr_kernels import ap_update, basis_flush, update_r
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.dirac import DiracOperator
from mgpgcr_tpu_torch.ops.dslash import CudaWilsonDirac
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
) -> SolveResult:
    """Solve A x = rhs with flexible GCR; fields are ``cplx.CF``.

    ``precond`` is the flexible RIGHT preconditioner, ``left_precond`` the
    LEFT one (GCR then runs on L A and L rhs, and the history is measured
    in the L-preconditioned norm). ``fused`` (default ``params.fused``)
    selects the restart-cycle form through the hand-written kernels."""
    if left_precond is not None:
        base_apply = a.apply if hasattr(a, "apply") else a
        a = lambda v: left_precond(base_apply(v))  # noqa: E731
        rhs = left_precond(rhs)
    if fused is None:
        fused = params.fused
    if fused:
        return _gcr_solve_fused_cycles(a, rhs, params, precond, x0)
    apply_a = a.apply if hasattr(a, "apply") else a
    rdtype, dev = rhs.dtype, rhs.device
    S = params.storage_size
    max_iter = params.max_iter
    restart = params.restart if params.restart else max_iter + 1

    x = cplx.zeros_like(rhs) if x0 is None else x0
    r = rhs - apply_a(x) if x0 is not None else rhs
    rhs_norm2 = cplx.abs2_sum(rhs)

    z = precond(r) if precond is not None else r
    p = z
    ap = apply_a(p)
    ps = cplx.stack_zeros(S, p)
    ps[0] = p
    aps = cplx.stack_zeros(S, ap)
    aps[0] = ap
    ap_norms = torch.zeros(S, dtype=rdtype, device=dev)
    ap_norms[0] = cplx.abs2_sum(ap)

    r2 = cplx.abs2_sum(r)
    hist = torch.full((max_iter + 1,), float("nan"), dtype=rdtype, device=dev)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    _record(hist, it, torch.ones((), dtype=torch.bool, device=dev), r2, rhs_norm2, rdtype)
    tol2 = params.tol**2
    check_every = params.restart or _CHECK_EVERY

    count = 0  # iterations since the last restart (host: data independent)
    n_body = 0
    while n_body % check_every or bool(_running(r2, rhs_norm2, tol2, it, max_iter)):
        n_body += 1
        active = _running(r2, rhs_norm2, tol2, it, max_iter)
        it = it + active
        count += 1

        ap2 = cplx.abs2_sum(ap)
        alpha = _div_real(cplx.vdot(ap, r), ap2, rdtype) * active.to(rdtype)
        x = x + p * alpha
        r = r - ap * alpha
        if params.residual_refresh and n_body % params.residual_refresh == 0:
            r = cplx.where(active, rhs - apply_a(x), r)
        r2 = cplx.abs2_sum(r)
        _record(hist, it, active, r2, rhs_norm2, rdtype)

        z = precond(r) if precond is not None else r
        az = apply_a(z)
        # beta_j = <Ap_j, Az> / ||Ap_j||^2, zero where the slot is empty
        raw = cplx.conj_contract_stack(aps, az)
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
        ap_norms[slot] = cplx.abs2_sum(ap)

    return _result(x, r2, rhs_norm2, tol2, it, hist, rdtype)


def _mega_step_config(a, precond):
    """Step function ``(r, aps, alpha, lim) -> (r', az, r2, raw, apr)`` when
    the one-pass GCR step applies: unpreconditioned A = I - kD with
    ``CudaWilsonDirac`` as D, single device. None otherwise."""
    if precond is not None or not isinstance(a, DiracOperator):
        return None
    d = a.d
    if not isinstance(d, CudaWilsonDirac) or d.mesh.spacetime_dims[0] < 2:
        return None

    def step(r, aps, alpha, lim):
        return gcr_stream_step(d.links, r, aps, alpha, a.k, lim, d.mesh, anti_t=d.anti_t)

    return step


def _z_step_config(a):
    """Step function ``(z, r, aps, lim) -> (az, raw, apr)`` when the
    preconditioned one-pass step applies: A = I - kD with
    ``CudaWilsonDirac`` as D and an even t extent of at least 2, the
    conditions of the JAX package's ``_z_step_config``. None otherwise."""
    if not isinstance(a, DiracOperator):
        return None
    d = a.d
    t = d.mesh.spacetime_dims[0] if isinstance(d, CudaWilsonDirac) else 0
    if t < 2 or t % 2:
        return None

    def zstep(z, r, aps, lim):
        return gcr_z_step(d.links, z, r, aps, a.k, lim, d.mesh, anti_t=d.anti_t)

    return zstep


def _gcr_solve_fused_cycles(a, rhs, params: GCRParams, precond, x0) -> SolveResult:
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
    K3 never reads r. Reference loop: GCR.h:222-288; JAX counterpart:
    ``_gcr_solve_fused_cycles``."""
    unroll_ok = params.unroll == "cycles" or (params.unroll == "auto" and precond is None)
    if not (params.restart and params.restart <= 16 and not params.residual_refresh and unroll_ok):
        raise NotImplementedError(
            "the fused solve is the restart-cycle form: restart <= 16, no "
            "residual_refresh, unroll 'cycles' ('auto' only without a "
            "preconditioner); the loop form's update_xr and dir_update "
            "kernels and truncation are still to port"
        )
    mega = _mega_step_config(a, precond)
    zstep = _z_step_config(a) if precond is not None else None
    if mega is None and zstep is None:
        raise NotImplementedError(
            "the fused solve needs A = DiracOperator(CudaWilsonDirac, k) with an "
            "even t extent (the beta_dots kernel for other operators is still "
            "to port)"
        )
    apply_a = a.apply
    rdtype, dev = rhs.dtype, rhs.device
    cdt = cplx.complex_dtype(rdtype)
    S = params.storage_size
    R = params.restart
    max_iter = params.max_iter

    x = cplx.zeros_like(rhs) if x0 is None else x0
    r = rhs - apply_a(x) if x0 is not None else rhs
    rhs_norm2 = cplx.abs2_sum(rhs)

    p0 = precond(r) if precond is not None else r
    ap = apply_a(p0)
    aps = cplx.stack_zeros(S, ap)
    aps[0] = ap
    ap2 = cplx.abs2_sum(ap)
    ap_norms = torch.zeros(S, dtype=rdtype, device=dev)
    ap_norms[0] = ap2
    apr = cplx.vdot(ap, r)

    r2 = cplx.abs2_sum(r)
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
                z = r
            else:
                r, r2 = update_r(r, aps, j, alpha)
            _record(hist, it, active, r2, rhs_norm2, rdtype)
            if mega is None:
                z = precond(r)
                az, raw, aprd = zstep(z, r, aps, j + 1)
            betas = torch.where(
                ap_norms > 0, _div_real(raw, ap_norms, rdtype), torch.zeros_like(raw)
            )

            # p_new = z - sum_i beta_i p_i, as coefficients over the basis
            basis.append(z)
            b = betas[: j + 1]
            coef[j + 1, : j + 1] = -(b @ coef[: j + 1, : j + 1])
            coef[j + 1, j + 1] = 1

            # <ap_new, r'> = <az, r'> - sum conj(beta_i) <ap_i, r'>
            apr = aprd[S] - torch.sum(b.conj() * aprd[: j + 1])
            slot = 0 if j == R - 1 else j + 1
            aps, ap2 = ap_update(az, aps, betas, slot, j + 1)
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
