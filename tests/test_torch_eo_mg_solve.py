"""The multigrid over the even-odd Schur system (``setup_eo_mg``) as a
preconditioner, f64, on the (4, 4, 2, 8) lattice of tests/test_eo.py: with
four null vectors and the default power iterations, the fused
MG-preconditioned Schur solve takes under half the plain Schur solve's
iterations near the critical k, and its reconstructed x solves the full
system to 1e-8 (as tests/test_eo.py's slow MG case). The setup's parity
with the JAX package is held in test_torch_eo_mg.py.
"""

import numpy as np
import pytest
import torch

from mgpgcr_tpu_torch import (
    DiracOperator,
    EvenOddWilson,
    GCRParams,
    LatticeMesh,
    MGParams,
    SlabWilsonDirac,
    cplx,
    eo_solve,
    setup_eo_mg,
)
from mgpgcr_tpu_torch.ops.wilson import random_links_np
from mgpgcr_tpu_torch.ops.wilson_slab import links_to_slab

DIMS = (4, 4, 2, 8, 4, 3)
K = 0.19  # near the critical k of these links, where MG pays


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mg_schur_solve():
    mesh = LatticeMesh(DIMS)
    slab = links_to_slab(cplx.from_numpy(random_links_np(31, mesh), torch.float64, "cpu"),
                         mesh)
    full, eo = SlabWilsonDirac(slab, mesh), EvenOddWilson.from_full(slab, mesh)
    gen = torch.Generator().manual_seed(11)
    _, mgp = setup_eo_mg(gen, eo, K, MGParams(block=2, n_nullvecs=4))
    rng = np.random.default_rng(35)
    shape = full.field_shape
    b = cplx.from_numpy(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                        torch.float64, "cpu")
    params = GCRParams(tol=1e-9, max_iter=600, restart=10, fused=True)
    plain = eo_solve(eo, K, b, params)
    res = eo_solve(eo, K, b, params, precond=mgp.apply)
    assert plain.converged and res.converged
    assert res.n_iters < plain.n_iters // 2, (res.n_iters, plain.n_iters)
    r = b - DiracOperator(full, K).apply(res.x)
    assert float(torch.sqrt(cplx.abs2_sum(r) / cplx.abs2_sum(b))) < 1e-8
