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
the eager cycles on the card in test_torch_cuda.py.

The coarse GCR kernels' cycle (``KernelCycle``), run through the plain
versions of the kernels on CPU tensors, against the generic loop on a
small block-stencil operator at restart 10: the same iteration count, the
history within 1e-5 relative and x within 1e-5, converging in the first
cycle or a later one, at max_iter 25 (cut inside the third cycle) and 50,
and from a zero right-hand side. ``CoarseSolve`` keeps the generic loop on
CPU tensors, in a rank thread, with a coarse preconditioner, on float64
fields and past a restart of 64 (``_kernel_cycles``)."""

import threading
import types

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
from mgpgcr_tpu_torch.ops.blockstencil import StencilBlockOperator
from mgpgcr_tpu_torch.solvers.gcr import _gcr_solve_generic
from mgpgcr_tpu_torch.solvers.mg import (
    CoarseSolve,
    KernelCycle,
    _alone,
    _kernel_cycles,
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
    assert counts["captures"] == 0 and counts["replays"] == 0 and counts["kernel_cycles"] == 0
    reset_coarse_cycle_counts()
    assert coarse_cycle_counts() == {"captures": 0, "replays": 0, "eager_cycles": 0,
                                     "kernel_cycles": 0}


def test_no_capture_in_a_rank_thread():
    """A capture has to be the process's only CUDA work while it lasts, so
    a rank thread of ``run_spmd`` keeps the eager cycles."""
    seen = []
    t = threading.Thread(target=lambda: seen.append(_alone()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [False]
    assert _alone()


# the kernels' cycle: a 2x2x2x4 block stencil of 6x6 blocks, I + 0.25-scaled
# random couplings (well conditioned) or 0.6 I + the same (slow, so the
# caps bind before convergence)
KERNEL_CASES = {
    "first_cycle": (1.0, GCRParams(tol=1e-2, max_iter=25, restart=10), torch.float64),
    "later_cycle": (1.0, GCRParams(tol=1e-8, max_iter=50, restart=10), torch.float64),
    "cap25": (0.6, GCRParams(tol=1e-8, max_iter=25, restart=10), torch.float64),
    "cap50": (0.6, GCRParams(tol=1e-8, max_iter=50, restart=10), torch.float64),
    "later_cycle_f32": (1.0, GCRParams(tol=1e-6, max_iter=50, restart=10), torch.float32),
    "cap25_f32": (0.6, GCRParams(tol=1e-8, max_iter=25, restart=10), torch.float32),
    "zero_rhs": (1.0, GCRParams(tol=1e-2, max_iter=50, restart=10), torch.float64),
}


def _stencil(shift: float, dtype):
    dims, ne = (2, 2, 2, 4), 6
    gen = torch.Generator().manual_seed(91)
    nb = int(np.prod(dims))
    b = cplx.random(gen, (nb, 2 * len(dims) + 1, ne, ne), dtype, "cpu")
    b = cplx.CF(b.re * 0.25 / ne**0.5, b.im * 0.25 / ne**0.5)
    b.re[:, 0] += shift * torch.eye(ne, dtype=dtype)
    return StencilBlockOperator(b, dims), cplx.random(gen, (nb * ne,), dtype, "cpu")


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_cycles_match_generic_loop(case):
    shift, params, dtype = KERNEL_CASES[case]
    op, rhs = _stencil(shift, dtype)
    if case == "zero_rhs":
        rhs = cplx.zeros_like(rhs)
    want = _gcr_solve_generic(op, rhs, params, None, None)
    loop = KernelCycle(op, rhs, params)
    reset_coarse_cycle_counts()
    CoarseSolve._drive(loop.cycle, loop.cycle, lambda: loop.state["going"], params.restart,
                       params.max_iter, ("eager_cycles",))
    state, n = loop.state, want.n_iters
    cycles = coarse_cycle_counts()["eager_cycles"]
    assert int(state["it"]) == n and not bool(state["going"])
    hist, hist_want = state["hist"].numpy(), want.res_history.numpy()
    assert np.array_equal(np.isnan(hist), np.isnan(hist_want))
    assert np.isnan(hist[n + 1:]).all()  # bodies past the stop are masked
    np.testing.assert_allclose(hist[: n + 1], hist_want[: n + 1], rtol=1e-5, atol=0)
    x, x_want = cplx.to_numpy(state["x"]), cplx.to_numpy(want.x)
    np.testing.assert_allclose(x, x_want, rtol=0, atol=1e-5 * max(np.abs(x_want).max(), 1e-30))
    if case == "zero_rhs":
        assert n == 0 and cycles == 1 and not np.abs(x).any()
        return
    # every cycle runs whole: the last one past the stop, masked
    assert cycles == -(-n // params.restart) and cycles * params.restart >= n
    if case.startswith("cap"):
        assert n == params.max_iter and not want.converged
    else:
        assert want.converged and (n <= params.restart) == (case == "first_cycle")
    if n > params.restart:
        assert cycles >= 2  # a restart inside the solve


def _cuda_like(dtype=torch.float32):
    """Stands in for a CUDA field where only the device and dtype are read."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype)


def test_kernel_cycles_only_where_graphed():
    """The coarse GCR kernels run on float32 CUDA fields at the coarsest
    level in restart mode, in the main thread; on CPU tensors, with a
    coarse preconditioner, in truncation or residual-refresh mode, on
    float64 fields, past a restart of 64 or in a rank thread, the generic
    loop runs."""
    params = GCRParams(tol=1e-2, max_iter=50, restart=10)
    assert _kernel_cycles(_cuda_like(), params, None)
    assert not _kernel_cycles(cplx.zeros_like(_stencil(1.0, torch.float32)[1]), params, None)
    assert not _kernel_cycles(_cuda_like(), params, lambda v: v)
    assert not _kernel_cycles(_cuda_like(), GCRParams(tol=1e-2, max_iter=50, truncation=10),
                              None)
    assert not _kernel_cycles(_cuda_like(), GCRParams(tol=1e-2, max_iter=50, restart=10,
                                                      residual_refresh=5), None)
    assert not _kernel_cycles(_cuda_like(torch.float64), params, None)
    assert not _kernel_cycles(_cuda_like(), GCRParams(tol=1e-2, max_iter=100, restart=65), None)
    seen = []
    t = threading.Thread(target=lambda: seen.append(_kernel_cycles(_cuda_like(), params, None)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [False]
    # and CoarseSolve on CPU tensors runs the generic loop's cycles
    op, rhs = _stencil(1.0, torch.float32)
    reset_coarse_cycle_counts()
    state = CoarseSolve().solve(op, rhs, params)
    counts = coarse_cycle_counts()
    assert "ap_norms" in state  # GenericLoop.STATE
    assert counts["eager_cycles"] >= 1 and counts["kernel_cycles"] == 0
    assert counts["captures"] == 0
