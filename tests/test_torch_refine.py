"""Port parity for mixed-precision refinement and the low eigenpairs, f64
unless named, 4^4 lattice, against the JAX package on inputs made with
numpy from a seed.

- ``refined_solve`` with the same callables (a fixed approximate inverse,
  numpy on the JAX side, torch on the port's): histories to rtol 1e-10
  with atol 1e-13, x to 1e-12 of scale, the same rounds; also where the
  stagnation guard stops it, and the zero right-hand side;
- ``wilson_refined_solve`` on f64 inner solves (so both sides compute the
  same numbers): the port's ``CudaWilsonDirac`` (the plain Dslash on CPU
  tensors) with ``wilson_apply_hi`` against JAX's ``TpuWilsonDirac`` with
  ``dirac_apply_np``, periodic and anti-periodic t: the same rounds and
  inner iterations, histories and x as above;
- the f32 path (two-row links, in-kernel anti-periodic sign, fused inner
  solves) refined to 1e-12 against ``dirac_apply_np``; with the periodic
  operator as ``apply_hi`` it solves the periodic system instead;
- ``smallest_eigenpairs`` on a dense operator from the same start
  vector: values, residuals and vectors to 1e-9 of scale (the power
  iteration's GCR solves run in another order, as in test_torch_mg.py),
  and each Rayleigh quotient and residual recomputed in numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dense import DenseOperator as JDense
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu.solvers.eigen import smallest_eigenpairs as j_smallest_eigenpairs
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu.solvers.refine import refined_solve as j_refined_solve
from mgpgcr_tpu.solvers.refine import wilson_refined_solve as j_wilson_refined_solve
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DenseOperator,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    cplx,
    refined_solve,
    smallest_eigenpairs,
    wilson_apply_hi,
    wilson_refined_solve,
)
from mgpgcr_tpu_torch.ops.wilson import antiperiodic_t, dirac_apply_np, random_links_np

DIMS = (4, 4, 4, 4)
K = 0.12
INNER = dict(tol=1e-3, max_iter=100, restart=5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def _same_history(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def _jcf(z):
    return jcplx.CF(jnp.asarray(z.real), jnp.asarray(z.imag))


@pytest.fixture(scope="module")
def problem():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = random_links_np(21, mesh)
    rng = np.random.default_rng(22)
    rhs = rng.standard_normal(mesh.size) + 1j * rng.standard_normal(mesh.size)
    return mesh, links, rhs


@pytest.mark.parametrize("contraction", ["contracts", "stagnates"])
def test_refined_solve_matches_jax(contraction):
    rng = np.random.default_rng(23)
    n = 48
    a = np.eye(n) + 0.3 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) / 7
    noise = 0.05 if contraction == "contracts" else 0.9
    m = np.linalg.inv(a) + noise * rng.standard_normal((n, n)) / 7  # an inexact inverse
    rhs = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    want = j_refined_solve(lambda r: m @ r, lambda x: a @ x, rhs, tol=1e-12)
    mt, at = torch.as_tensor(m), torch.as_tensor(a)
    got = refined_solve(lambda r: mt @ r, lambda x: at @ x, rhs, tol=1e-12, device="cpu")
    assert (got.converged, got.n_refine) == (want.converged, want.n_refine)
    assert got.converged == (contraction == "contracts")
    _same_history(got.history, want.history)
    _close(got.x, want.x)
    assert isinstance(got.x, np.ndarray) and got.x.dtype == np.complex128


def test_refined_solve_zero_rhs():
    got = refined_solve(lambda r: r, lambda x: x, np.zeros(8, np.complex128), device="cpu")
    want = j_refined_solve(lambda r: r, lambda x: x, np.zeros(8, np.complex128))
    assert got.converged and got.final_relres == 0.0 and got.n_refine == 0
    assert got.history == want.history and np.array_equal(got.x, want.x)


@pytest.mark.parametrize("anti", [False, True])
def test_wilson_refined_solve_matches_jax(problem, anti):
    mesh, links, rhs = problem
    lk = antiperiodic_t(links) if anti else links
    jd = TpuWilsonDirac.build(_jcf(lk), JMesh(mesh.dims))
    ja = JDirac(jd, jcplx.from_scalar(K, jnp.float64))
    want = j_wilson_refined_solve(ja, JMesh(mesh.dims), rhs, JGCRParams(**INNER),
                                  lambda x: dirac_apply_np(lk, mesh, x, K), tol=1e-12)
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=anti, link_dtype=torch.float64,
                              device="cpu")
    apply_hi = wilson_apply_hi(links, mesh, K, antiperiodic=anti, device="cpu")
    got = wilson_refined_solve(DiracOperator(d, K), mesh, rhs, GCRParams(**INNER), apply_hi,
                               tol=1e-12)
    assert got.converged and want.converged
    assert got.n_refine == want.n_refine and got.inner_iters == want.inner_iters
    _same_history(got.history, want.history)
    _close(got.x, want.x)
    rel = np.linalg.norm(rhs - dirac_apply_np(lk, mesh, got.x, K)) / np.linalg.norm(rhs)
    assert rel <= 1e-12


def test_wilson_refined_solve_f32(problem):
    mesh, links, rhs = problem
    d = CudaWilsonDirac.build(links, mesh, compress=True, antiperiodic_t=True, device="cpu")
    inner = GCRParams(tol=1e-5, max_iter=300, restart=5, fused=True)
    res = wilson_refined_solve(DiracOperator(d, K), mesh, rhs, inner,
                               wilson_apply_hi(links, mesh, K, antiperiodic=True, device="cpu"),
                               tol=1e-12)
    assert res.converged and res.final_relres <= 1e-12 and res.n_refine <= 6
    assert all(b < a for a, b in zip(res.history, res.history[1:]))
    assert len(res.inner_iters) == res.n_refine and res.total_inner_iters > 0
    ap = antiperiodic_t(links)
    rel = np.linalg.norm(rhs - dirac_apply_np(ap, mesh, res.x, K)) / np.linalg.norm(rhs)
    assert rel <= 1e-12
    # the periodic operator as the trusted residual: refinement then
    # solves the periodic system, which is not the one asked for
    bad = wilson_refined_solve(DiracOperator(d, K), mesh, rhs, inner,
                               wilson_apply_hi(links, mesh, K, device="cpu"), tol=1e-12)
    rel = np.linalg.norm(rhs - dirac_apply_np(ap, mesh, bad.x, K)) / np.linalg.norm(rhs)
    assert rel > 1e-3


def test_smallest_eigenpairs_matches_jax():
    # a dense operator: the eigensolver is operator-generic, and a dense
    # matvec keeps the JAX side's two compiled solves (with and without x0)
    # cheap
    rng = np.random.default_rng(24)
    n = 96
    a = np.eye(n) + 0.4 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) / 14
    b0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    params = dict(tol=1e-8, max_iter=10, restart=10)
    want = j_smallest_eigenpairs(None, JDense(_jcf(a)), 3, _jcf(b0), JGCRParams(**params),
                                 n_power_iters=4)
    got = smallest_eigenpairs(None, DenseOperator(torch.as_tensor(a)), 3,
                              cplx.from_numpy(b0, torch.float64, "cpu"), GCRParams(**params),
                              n_power_iters=4)
    _close(got.values, want.values, 1e-9)
    _close(got.residuals, want.residuals, 1e-9)
    _close(cplx.to_numpy(got.vectors), jcplx.to_numpy(want.vectors), 1e-9)
    # each pair's residual and Rayleigh quotient, recomputed in numpy
    v = cplx.to_numpy(got.vectors)
    for i in range(3):
        assert abs(np.vdot(v[i], a @ v[i]) - got.values[i]) <= 1e-12
        assert abs(np.linalg.norm(a @ v[i] - got.values[i] * v[i]) - got.residuals[i]) <= 1e-12
    # the smallest of A's eigenvalues are what inverse iteration finds
    lam = np.sort(np.abs(np.linalg.eigvals(a)))
    assert abs(abs(got.values[0]) - lam[0]) <= 0.05 * lam[0]
