"""Mixed-precision iterative refinement.

Counterpart of ``mgpgcr_tpu/solvers/refine.py``. The reference solves in
complex128 to tol 1e-13 (GCR.h:288, main.cpp:858); the kernels of the port
run f32, whose attainable relative residual bottoms out near 1e-6.
Classical refinement recovers double precision:

    x_{k+1} = x_k + Solve_lo(rhs - A_hi x_k),

the residual in complex128, only the correction solved in low precision.
Each round multiplies the residual by the low-precision solver's
contraction factor.

The interface is numpy complex128, as in the JAX package; the work (the x
update, rhs - A_hi x, the norms) is torch complex128 on the caller's
device, so on the card neither the f64 residual nor the solution crosses
to the host between rounds: only the relative residual does, once a round.
``solve_lo`` and ``apply_hi`` take and return complex128 tensors on that
device. ``wilson_refined_solve`` wires the Wilson--Dirac path: the inner
solve is ``gcr_solve`` on slab f32 fields (the kernels on the card), and
``wilson_apply_hi`` gives the f64 operator on the card (``SlabWilsonDirac``
with f64 links).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray  # complex128 solution
    converged: bool
    n_refine: int  # refinement rounds taken
    final_relres: float  # true complex128 relative residual
    history: list  # relres after each round (history[0] = 1.0)
    # inner solver iterations per round (filled by wilson_refined_solve);
    # the reference's iterations-to-tol maps to their sum
    inner_iters: list = dataclasses.field(default_factory=list)

    @property
    def total_inner_iters(self) -> int:
        return int(sum(self.inner_iters))


def _c128(v, device) -> torch.Tensor:
    return torch.as_tensor(v).to(device, torch.complex128)


def refined_solve(
    solve_lo: Callable[[torch.Tensor], torch.Tensor],
    apply_hi: Callable[[torch.Tensor], torch.Tensor],
    rhs,
    tol: float = 1e-12,
    max_refine: int = 30,
    device=None,
) -> RefineResult:
    """Iterative refinement to complex128 accuracy.

    solve_lo(r) -> approximately A^-1 r (any precision inside);
    apply_hi(x) -> A x in complex128 (the trusted residual operator);
    both on complex128 tensors on ``device`` (CUDA unless named); rhs a
    complex ndarray or tensor."""
    dev = cplx.resolve_device(device)
    rhs = _c128(rhs, dev)
    rhs_norm = float(torch.linalg.vector_norm(rhs))
    if rhs_norm == 0.0:
        return RefineResult(np.zeros(tuple(rhs.shape), np.complex128), True, 0, 0.0, [0.0])
    x = torch.zeros_like(rhs)
    r = rhs.clone()
    history = [1.0]
    for it in range(1, max_refine + 1):
        x = x + _c128(solve_lo(r), dev)
        r = rhs - _c128(apply_hi(x), dev)
        rel = float(torch.linalg.vector_norm(r)) / rhs_norm
        history.append(rel)
        if rel <= tol:
            return RefineResult(x.cpu().numpy(), True, it, rel, history)
        # stagnation guard: the low-precision solver no longer contracts
        if len(history) >= 3 and rel > 0.5 * history[-2]:
            break
    return RefineResult(x.cpu().numpy(), history[-1] <= tol, len(history) - 1, history[-1],
                        history)


def wilson_apply_hi(links_canonical, mesh, k, antiperiodic: bool = False, device=None):
    """A_hi x = x - k D x in complex128 on flat canonical fields (N,), by
    ``SlabWilsonDirac`` with f64 links on ``device`` (CUDA unless named).
    ``antiperiodic`` folds the anti-periodic t sign into the f64 links (the
    f32 kernel applies it in-kernel; the residual must see the same
    operator, or refinement stalls near 1e-2)."""
    from mgpgcr_tpu_torch.ops.dirac import DiracOperator
    from mgpgcr_tpu_torch.ops.dslash import _canonical_cf
    from mgpgcr_tpu_torch.ops.wilson import antiperiodic_t
    from mgpgcr_tpu_torch.ops.wilson_slab import SlabWilsonDirac, field_from_slab, field_to_slab

    dev = cplx.resolve_device(device)
    links = _canonical_cf(links_canonical, dev, torch.float64)
    if antiperiodic:
        links = antiperiodic_t(links)
    a = DiracOperator(SlabWilsonDirac.build(links, mesh), k)

    def apply_hi(x: torch.Tensor) -> torch.Tensor:
        y = a.apply(cplx.ascf(field_to_slab(x, mesh)).contiguous())
        return field_from_slab(torch.complex(y.re, y.im), mesh)

    return apply_hi


def wilson_refined_solve(
    a_lo,
    mesh,
    rhs,
    inner_params,
    apply_hi: Callable[[torch.Tensor], torch.Tensor],
    precond=None,
    tol: float = 1e-12,
    max_refine: int = 30,
) -> RefineResult:
    """Refinement around a slab-layout operator ``a_lo`` (a
    ``DiracOperator`` over ``CudaWilsonDirac`` or ``SlabWilsonDirac``): each
    round scales the residual into the inner precision's range, solves with
    ``gcr_solve(a_lo, ., inner_params, precond)`` on the operator's device,
    and scales back. ``apply_hi``: the complex128 operator on flat
    canonical fields on that device (e.g. :func:`wilson_apply_hi`). rhs:
    flat complex128 (N,)."""
    from mgpgcr_tpu_torch.ops.wilson_slab import field_from_slab, field_to_slab
    from mgpgcr_tpu_torch.solvers.gcr import gcr_solve

    d = getattr(a_lo, "d", a_lo)
    rdt, dev = d.dtype, d.device
    inner_iters: list = []

    def solve_lo(r: torch.Tensor) -> torch.Tensor:
        scale = float(r.abs().max()) or 1.0
        rs = field_to_slab(r / scale, mesh)
        r_cf = cplx.CF(rs.real.to(rdt).contiguous(), rs.imag.to(rdt).contiguous())
        res = gcr_solve(a_lo, r_cf, inner_params, precond=precond)
        inner_iters.append(int(res.n_iters))
        dx = field_from_slab(res.x.astype(torch.float64), mesh)
        return torch.complex(dx.re, dx.im) * scale

    out = refined_solve(solve_lo, apply_hi, rhs, tol=tol, max_refine=max_refine, device=dev)
    out.inner_iters = inner_iters
    return out
