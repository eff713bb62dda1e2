"""Port parity for the GCR solver: the port's generic loop and its
restart-cycle fused form (K2-K4 through their plain versions on CPU
tensors) against ``mgpgcr_tpu.gcr_solve`` on the same operator (same
links, anti-periodic t, same k and right-hand side). The loop form and the
eager forms are held to JAX in test_torch_gcr_loop.py.

Generic path, float64: residual histories equal to rtol 1e-10 (atol
1e-13), same iteration count. Fused path: float64 to rtol 1e-10 (atol 1e-13), and
float32 to rtol 1e-4 with the same iteration count. The JAX side is its generic loop on
``TpuWilsonDirac``; the JAX package's own tests hold its fused-cycles
solve equal to that loop (tests/test_gcr_fused.py), and the kernels one
by one are held against the JAX kernels in test_torch_gcr_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.wilson import antiperiodic_t
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu.solvers.gcr import gcr_solve as j_gcr_solve
from mgpgcr_tpu.solvers.params import GCRParams as JParams
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    GCRSolver,
    LatticeMesh,
    SlabWilsonDirac,
    cplx,
    gcr_solve,
)
from mgpgcr_tpu_torch.ops import wilson

DIMS = (4, 4, 4, 4)
K = 0.12
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}


@pytest.fixture(scope="module")
def problem():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = wilson.random_links_np(41, mesh)
    rng = np.random.default_rng(42)
    shape = (4, 3, DIMS[0], DIMS[1], DIMS[2] * DIMS[3])
    rhs = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return mesh, links, rhs


_JAX_RESULTS = {}


def _jax_solve(problem, dtype, params: JParams):
    """The JAX package's solve, computed once per (dtype, params)."""
    key = (jnp.dtype(dtype).name, params)
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = _jax_solve_uncached(problem, dtype, params)
    return _JAX_RESULTS[key]


def _jax_solve_uncached(problem, dtype, params: JParams):
    mesh, links, rhs = problem
    jl = antiperiodic_t(links)
    jd = TpuWilsonDirac.build(
        jcplx.CF(jnp.asarray(jl.real, dtype), jnp.asarray(jl.imag, dtype)), JMesh(mesh.dims)
    )
    a = JDirac(jd, jcplx.from_scalar(K, dtype))
    b = jcplx.CF(jnp.asarray(rhs.real, dtype), jnp.asarray(rhs.imag, dtype))
    return jax.jit(lambda a, b: j_gcr_solve(a, b, params))(a, b)


def _port(problem, dtype):
    mesh, links, rhs = problem
    d = CudaWilsonDirac.build(
        links, mesh, compress=True, antiperiodic_t=True, link_dtype=dtype, device="cpu"
    )
    return DiracOperator(d, K), cplx.from_numpy(rhs, dtype, "cpu")


def _history(res):
    if hasattr(res, "history_list"):
        return np.asarray(res.history_list())
    h = np.asarray(res.res_history)
    return h[~np.isnan(h)]


def _compare(got, want, rtol):
    assert got.n_iters == int(want.n_iters)
    assert got.converged == bool(want.converged)
    # atol as in tests/test_gcr_fused.py: a refreshed residual near 1e-9
    # carries the operator's f64 roundoff, ~1e-16 absolute
    atol = 1e-13 if rtol < 1e-6 else 0.0
    np.testing.assert_allclose(_history(got), _history(want), rtol=rtol, atol=atol)
    xw = jcplx.to_numpy(want.x)
    np.testing.assert_allclose(
        cplx.to_numpy(got.x), xw, rtol=0, atol=10 * rtol * np.abs(xw).max()
    )


GENERIC = {
    "restart": dict(tol=1e-9, max_iter=60, restart=5),
    "truncation": dict(tol=1e-9, max_iter=60, truncation=4),
    "refresh": dict(tol=1e-9, max_iter=40, restart=3, residual_refresh=7),
}


@pytest.mark.parametrize("name", sorted(GENERIC))
def test_generic_matches_jax_f64(problem, name):
    kw = GENERIC[name]
    a, b = _port(problem, torch.float64)
    got = gcr_solve(a, b, GCRParams(**kw))
    want = _jax_solve(problem, jnp.float64, JParams(**kw))
    _compare(got, want, 1e-10)


@pytest.mark.parametrize("dt,rtol", [("f64", 1e-10), ("f32", 1e-4)])
def test_fused_cycles_matches_jax(problem, dt, rtol):
    tdt, jdt = DTYPES[dt]
    kw = GENERIC["restart"] if dt == "f64" else dict(tol=1e-5, max_iter=60, restart=5)
    a, b = _port(problem, tdt)
    got = gcr_solve(a, b, GCRParams(fused=True, **kw))
    want = _jax_solve(problem, jdt, JParams(**kw))
    assert got.converged
    _compare(got, want, rtol)


def test_fused_stops_mid_cycle_at_max_iter(problem):
    a, b = _port(problem, torch.float64)
    kw = dict(tol=1e-12, max_iter=13, restart=5)
    got = gcr_solve(a, b, GCRParams(fused=True, **kw))
    ref = gcr_solve(a, b, GCRParams(**kw))
    assert got.n_iters == ref.n_iters == 13 and not got.converged
    np.testing.assert_allclose(_history(got), _history(ref), rtol=1e-10)


def test_fused_refuses_what_it_cannot_run(problem):
    """Truncation and an operator without a one-pass step were once refused
    by the fused solve. It now runs both: truncation in the loop form
    (update_xr, beta_dots, dir_update), ``SlabWilsonDirac`` in the cycles
    form (update_r, beta_dots, the r form of ap_update); both match JAX."""
    a, b = _port(problem, torch.float64)
    kw = GENERIC["truncation"]
    got = gcr_solve(a, b, GCRParams(fused=True, **kw))
    _compare(got, _jax_solve(problem, jnp.float64, JParams(**kw)), 1e-10)
    mesh, links, _ = problem
    slab = DiracOperator(SlabWilsonDirac.build(
        cplx.from_numpy(wilson.antiperiodic_t(links), torch.float64, "cpu"), mesh), K)
    kw = GENERIC["restart"]
    got = gcr_solve(slab, b, GCRParams(fused=True, **kw))
    _compare(got, _jax_solve(problem, jnp.float64, JParams(**kw)), 1e-10)


def test_zero_rhs_and_solver_object(problem):
    a, b = _port(problem, torch.float64)
    zero = cplx.zeros_like(b)
    res = gcr_solve(a, zero, GCRParams(tol=1e-8, max_iter=10, restart=5, fused=True))
    assert res.converged and res.n_iters == 0
    params = GCRParams(tol=1e-8, max_iter=40, restart=5)
    x = GCRSolver(a, params)(b)
    assert np.array_equal(cplx.to_numpy(x), cplx.to_numpy(gcr_solve(a, b, params).x))
    with pytest.raises(ValueError):
        GCRParams(restart=5, truncation=4)
