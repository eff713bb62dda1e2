"""The port's distributed MG-preconditioned solve (``solvers/mg_dist.py``),
float64, CPU, 4^4 lattice, k = 0.12, anti-periodic t, two-row links,
block 2, one near-null vector, the fused GCR(2) smoother on shards (B15's
plain version). Imports no JAX: the single-device reference is the port's
own ``setup_mg_from`` on the same start vector, which
tests/test_torch_mg_dist.py holds to JAX's ``setup_mg``.

- Outer solve: ``mg_gcr_solve_sharded`` on (2, 1) and (2, 2) ThreadComm
  grids (dense coarse, replicated coarse solve) and on (1, 2) (shard-local
  stencil coarse, distributed coarse solve) takes the outer iterations of the
  single-device MG solve (fused restart-5 outer GCR to 1e-8), its gathered
  x within 1e-8 of scale of the single-device x, independent residual at
  the tolerance.

The two-process gloo run of the same per-rank body is in
test_torch_mg_dist_gloo.py.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    LatticeMesh,
    cplx,
    gather_field,
    gcr_solve,
    make_shard_grid,
    mg_gcr_solve_sharded,
    run_spmd,
    setup_mg_from,
    shard_field,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mg_dist_worker as worker  # noqa: E402

K = 0.12
DIMS = (4, 4, 4, 4)


@pytest.fixture(autouse=True)
def thread_ranks():
    """Ranks as threads of one process: a short switch interval and one
    intra-op thread each, restored after the test."""
    old, old_threads = sys.getswitchinterval(), torch.get_num_threads()
    sys.setswitchinterval(1e-4)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        sys.setswitchinterval(old)
        torch.set_num_threads(old_threads)


@pytest.fixture(scope="module")
def problem():
    return worker.make_problem(DIMS, K)


@pytest.mark.parametrize("sizes,fmt", [((2, 1), "dense"), ((2, 2), "dense"), ((1, 2), "stencil")])
def test_outer_iterations_match_single_device(problem, sizes, fmt):
    mg = dataclasses.replace(worker.MG, coarse_format=fmt)
    mesh = LatticeMesh((*DIMS, 4, 3))
    d1 = CudaWilsonDirac.build(problem["links"], mesh, compress=True, antiperiodic_t=True,
                               link_dtype=torch.float64, device="cpu")
    a1 = DiracOperator(d1, torch.tensor(K, dtype=torch.complex128))
    ref_mg = setup_mg_from(cplx.from_numpy(problem["b0"], torch.float64, "cpu"), a1, mesh, mg)
    rhs = cplx.from_numpy(problem["rhs"], torch.float64, "cpu")
    outer = dataclasses.replace(worker.OUTER, tol=1e-8)
    ref = gcr_solve(a1, rhs, outer, precond=ref_mg.apply)
    assert ref.converged

    grid = make_shard_grid(sizes, ("t", "z"), device="cpu")

    def rank(comm):
        mgp = worker.rank_setup(problem, comm, "z", mg)
        return mg_gcr_solve_sharded(shard_field(rhs, grid, comm.rank, "t", "z"), outer, mgp)

    out = run_spmd(grid, rank, timeout=120)
    assert all(o.converged and o.n_iters == ref.n_iters for o in out)
    x = gather_field([o.x for o in out], grid, "t", "z")
    scale = float(cplx.abs2_sum(ref.x).sqrt())
    assert float(cplx.abs2_sum(x - ref.x).sqrt()) <= 1e-8 * scale
    r = rhs - a1.apply(x)
    assert float(torch.sqrt(cplx.abs2_sum(r) / cplx.abs2_sum(rhs))) <= 1e-8 * 1.01
