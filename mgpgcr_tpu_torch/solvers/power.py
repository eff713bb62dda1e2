"""Near-null vectors by inverse power iteration.

Counterpart of ``mgpgcr_tpu/solvers/power.py`` (the reference's
``Arnoldi``, MG.h:72-122): 10 inexact GCR inverse applications for the
first vector (MG.h:101-105), then one solve, modified Gram--Schmidt and
normalisation per further vector (MG.h:110-121). The JAX package jits
each solve (``gcr_solve_jit``); here each is the port's ``gcr_solve``.
With a communicator (the JAX package's ``axis_names``) ``a`` and ``b0``
are this rank's shards, and every norm, dot and GCR reduction is summed
over the ranks.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.solvers.gcr import _allsum, gcr_solve
from mgpgcr_tpu_torch.solvers.params import GCRParams


def _normalize(v, comm=None):
    return cplx.scale_real(v, 1.0 / torch.sqrt(_allsum(cplx.abs2_sum(v), comm)))


def inverse_power_vectors(a, b0, n_vecs: int, params: GCRParams, n_power_iters: int = 10,
                          comm=None):
    """(n_vecs, *field_shape) approximately orthonormal low modes of ``a``,
    stacked on a new leading axis, in b0's representation (a CF). Every
    rank of ``comm`` must call it together."""
    b = _normalize(b0, comm)
    for _ in range(n_power_iters):
        b = _normalize(gcr_solve(a, b, params, x0=b, comm=comm).x, comm)
    vecs = [b]
    for _ in range(1, n_vecs):
        w = gcr_solve(a, vecs[-1], params, comm=comm).x
        for v in vecs:
            w = w - v * _allsum(cplx.vdot(v, w), comm)
        vecs.append(_normalize(w, comm))
    return cplx.stack(vecs, axis=0)
