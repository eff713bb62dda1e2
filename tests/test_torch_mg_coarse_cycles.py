"""The V-cycle's coarse GCR run one restart cycle at a time
(``solvers/mg.py::CoarseSolve``, ``solvers/gcr.py::GenericLoop.cycle``),
eagerly on CPU tensors, float64, against the generic loop
(``_gcr_solve_generic``) on the same coarse operator: x, the iteration
count and the residual history are equal bit for bit, with the
block-stencil, block-ELL and dense coarse operators of one two-level
hierarchy (4^4, block 2, ne = 4, k = 0.12), converging inside the first
cycle, in a later one, or stopping at ``max_iter`` partway through a
cycle; a zero right-hand side gives x = 0 after no iteration. On CPU
tensors, with a three-level hierarchy and under left preconditioning, the
coarse solve runs eagerly and captures no CUDA graph
(``coarse_cycle_counts``); a rank thread (the sharded MG's replicated
levels) is never a place to capture one. The replayed graphs are held to
the eager cycles on the card in test_torch_cuda.py."""

import threading

import numpy as np
import pytest
import torch

from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    coarse_cycle_counts,
    cplx,
    gcr_solve,
    reset_coarse_cycle_counts,
)
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.solvers.gcr import _gcr_solve_generic
from mgpgcr_tpu_torch.solvers.mg import (
    CoarseSolve,
    _alone,
    build_coarse_operator,
    setup_mg_from,
)

DIMS = (4, 4, 4, 4)
K = 0.12
# (params, where the solve stops): inside the first restart cycle, in a
# later one, and at max_iter in the middle of the third cycle
STOPS = {
    "first_cycle": (GCRParams(tol=1e-1, max_iter=50, restart=10), "converged"),
    "later_cycle": (GCRParams(tol=1e-10, max_iter=200, restart=3), "converged"),
    "max_iter": (GCRParams(tol=1e-14, max_iter=7, restart=3), "max_iter"),
}


@pytest.fixture(scope="module")
def hier():
    """A two-level hierarchy with the block-stencil coarse operator, the
    block-ELL and dense operators of the same blocks, and a fine operator
    and right-hand side."""
    mesh = LatticeMesh((*DIMS, 4, 3))
    d = CudaWilsonDirac.build(wilson.random_links_np(81, mesh), mesh, antiperiodic_t=True,
                              link_dtype=torch.float64, device="cpu")
    a = DiracOperator(d, K)
    params = MGParams(block=2, n_nullvecs=2, coarse_format="stencil", smoother_gcr=None)
    gen = torch.Generator().manual_seed(82)
    mgp = setup_mg_from(cplx.random(gen, d.field_shape, torch.float64, "cpu"), a, mesh, params)
    table = mgp.block_map.neighbor_table()
    bpd = mgp.block_map.blocks_per_dim
    coarse = {fmt: build_coarse_operator(mgp.coarse.blocks, table, fmt, bpd)
              for fmt in ("stencil", "bsr", "dense")}
    rhs = cplx.random(gen, d.field_shape, torch.float64, "cpu")
    return dict(mesh=mesh, a=a, mgp=mgp, coarse=coarse, rhs=rhs, rc=mgp.restrict(rhs))


def _equal(got: cplx.CF, want: cplx.CF):
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


@pytest.mark.parametrize("stop", sorted(STOPS))
@pytest.mark.parametrize("fmt", ["stencil", "bsr", "dense"])
def test_cycles_equal_generic_loop(hier, fmt, stop):
    params, how = STOPS[stop]
    op = hier["coarse"][fmt]
    state = CoarseSolve().solve(op, hier["rc"], params)
    want = _gcr_solve_generic(op, hier["rc"], params, None, None)
    _equal(state["x"], want.x)
    assert int(state["it"]) == want.n_iters
    np.testing.assert_array_equal(state["hist"].numpy(), want.res_history.numpy())
    restart = params.restart
    if how == "max_iter":
        assert want.n_iters == params.max_iter and not want.converged
        assert params.max_iter % restart  # the last cycle runs past max_iter, masked
    else:
        assert want.converged
        assert (want.n_iters <= restart) == (stop == "first_cycle")


def test_zero_rhs_gives_zero(hier):
    zero = cplx.zeros_like(hier["rc"])
    state = CoarseSolve().solve(hier["coarse"]["stencil"], zero, STOPS["later_cycle"][0])
    assert int(state["it"]) == 0
    assert not bool(state["going"])
    _equal(state["x"], zero)


def _three_level(hier):
    params = MGParams(block=2, n_nullvecs=2, coarse_format="stencil", smoother_gcr=None,
                      n_level=3, coarse_block=2)
    gen = torch.Generator().manual_seed(83)
    b0 = [cplx.random(gen, hier["a"].d.field_shape, torch.float64, "cpu"),
          cplx.random(gen, (hier["mgp"].coarse.shape[0],), torch.float64, "cpu")]
    mgp = setup_mg_from(b0, hier["a"], hier["mesh"], params)
    assert mgp.coarse_precond is not None
    return lambda: mgp.apply(hier["rhs"])


def _left_preconditioned(hier):
    params = GCRParams(tol=1e-8, max_iter=40, restart=5)
    return lambda: gcr_solve(hier["a"], hier["rhs"], params, left_precond=hier["mgp"].apply)


@pytest.mark.parametrize("run", [_three_level, _left_preconditioned],
                         ids=["three_level", "left_precond"])
def test_cpu_coarse_solve_runs_eagerly(hier, run):
    go = run(hier)
    reset_coarse_cycle_counts()
    go()
    counts = coarse_cycle_counts()
    assert counts["eager_cycles"] > 0
    assert counts["captures"] == 0 and counts["replays"] == 0
    reset_coarse_cycle_counts()
    assert coarse_cycle_counts() == {"captures": 0, "replays": 0, "eager_cycles": 0}


def test_no_capture_in_a_rank_thread():
    """A capture has to be the process's only CUDA work while it lasts, so
    a rank thread of ``run_spmd`` keeps the eager cycles."""
    seen = []
    t = threading.Thread(target=lambda: seen.append(_alone()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [False]
    assert _alone()
