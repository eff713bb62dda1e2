"""Low-mode eigensolver: inverse iteration with Rayleigh-quotient values.

Counterpart of ``mgpgcr_tpu/solvers/eigen.py`` (the reference's eigen
setup, the misnamed ``Arnoldi``, MG.h:72-122, checked there by
``test_EigenSolver``, main.cpp:145-191): approximate smallest-|lambda|
eigenpairs by inverse power iteration with an inexact GCR inverse
(``solvers/power.py``), with Rayleigh quotients and residual norms so
callers can judge their quality.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.solvers.params import GCRParams
from mgpgcr_tpu_torch.solvers.power import inverse_power_vectors


@dataclasses.dataclass
class EigenResult:
    vectors: cplx.CF  # (n, ...) stacked approximate eigenvectors
    values: np.ndarray  # (n,) complex Rayleigh quotients <v, A v>
    residuals: np.ndarray  # (n,) real ||A v - lambda v|| per unit vector


def smallest_eigenpairs(key, a, n: int, b0: cplx.CF, params: GCRParams | None = None,
                        n_power_iters: int = 10) -> EigenResult:
    """The n smallest-magnitude eigenpairs of ``a``, approximately, from
    the start field ``b0`` (a CF in the operator's layout). ``key`` is
    unused: b0 decides the result; it stays for symmetry with the JAX
    package's signature."""
    del key
    if params is None:
        params = GCRParams(tol=1e-8, max_iter=10, restart=10)
    vecs = inverse_power_vectors(a, b0, n, params, n_power_iters)
    values = np.empty(n, dtype=np.complex128)
    residuals = np.empty(n, dtype=np.float64)
    for i in range(n):
        v = vecs[i]
        av = a.apply(v)
        lam = complex(cplx.vdot(v, av))
        values[i] = lam
        residuals[i] = float(torch.sqrt(cplx.abs2_sum(av - v * lam)))
    return EigenResult(vectors=vecs, values=values, residuals=residuals)
