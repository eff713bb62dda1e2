"""Port parity for the canonical Wilson--Dirac operator and the mu-major
operator of kernel B13, against the JAX package on numpy links made from a
seed (a ``torch.Generator`` and a JAX key give other numbers).

- ``WilsonDiracOperator`` on flat and lattice-shaped fields, complex and
  CF, against JAX's, f64, to 1e-12 of scale; ``random_links`` and
  ``random_links_cf`` give SU(3) links (unitary, det 1, to 1e-12);
- B13's plain version, through ``CudaWilsonDirac.build(..., tb=2, zb=8,
  antiperiodic_t=True)``, against ``PallasWilsonDirac`` with the same
  blocks in interpret mode (``dslash_apply(..., tb=2, zb=8,
  interpret=True)``, one compiled program) at (T, Z, Y, X) = (4, 16, 4, 4),
  f32, to 1e-5 of scale; the fused A = I - kD against the t-major
  operator with the in-kernel sign, to 1e-12 in f64;
- the mu-major fused restart-5 solve (update_r, A z, beta_dots and
  ap_update with r through their plain versions: the one-pass steps
  decline mu-major links) against the JAX package's ``gcr_solve`` on
  ``TpuWilsonDirac``, f64: the same iteration count, histories to rtol
  1e-10, x to 1e-10 of scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.pallas.dslash import PallasWilsonDirac
from mgpgcr_tpu.ops.wilson import WilsonDiracOperator as JWilson
from mgpgcr_tpu.ops.wilson import antiperiodic_t
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu.solvers.gcr import gcr_solve as j_gcr_solve
from mgpgcr_tpu.solvers.params import GCRParams as JParams
from mgpgcr_tpu_torch import CudaWilsonDirac, DiracOperator, GCRParams, LatticeMesh, cplx, gcr_solve
from mgpgcr_tpu_torch.kernels.dslash import dslash_mu
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.solvers.gcr import _mega_step_config, _z_step_config

K = 0.12


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _cz(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _jcf(z, dt=jnp.float64):
    return jcplx.CF(jnp.asarray(z.real, dt), jnp.asarray(z.imag, dt))


def test_canonical_operator_matches_jax():
    mesh = LatticeMesh((4, 4, 2, 4, 4, 3))
    links = wilson.random_links_np(61, mesh)
    rng = np.random.default_rng(62)
    x = _cz(rng, (2, mesh.size))
    jop = JWilson(jnp.asarray(links), JMesh(mesh.dims))
    op = wilson.WilsonDiracOperator(torch.as_tensor(links), mesh)
    assert op.shape == jop.shape and op.dim == mesh.size
    want = np.asarray(jop.apply(jnp.asarray(x)))
    _close(op.apply(torch.as_tensor(x)).numpy(), want, 1e-12)
    got_cf = op.apply(cplx.from_numpy(x[0].reshape(mesh.dims), torch.float64, "cpu"))
    _close(cplx.to_numpy(got_cf).reshape(-1), want[0], 1e-12)
    np.testing.assert_allclose(wilson.dirac_apply_np(links, mesh, x[1]), want[1], atol=1e-12)
    a = DiracOperator(op, K)
    _close(a.apply(torch.as_tensor(x[0])).numpy(), x[0] - K * want[0], 1e-12)


def test_random_links_are_su3():
    mesh = LatticeMesh((2, 2, 2, 4, 4, 3))
    u = wilson.random_links(torch.Generator().manual_seed(5), mesh)
    assert u.shape == (4, 2, 2, 2, 4, 3, 3) and u.dtype == torch.complex128
    eye = torch.eye(3, dtype=u.dtype)
    assert float((u @ u.mH - eye).abs().max()) <= 1e-12
    assert float((torch.linalg.det(u) - 1).abs().max()) <= 1e-12
    cf = wilson.random_links_cf(torch.Generator().manual_seed(5), mesh, torch.float64)
    assert np.array_equal(cplx.to_numpy(cf), u.numpy())


@pytest.fixture(scope="module")
def mu_problem():
    mesh = LatticeMesh((4, 16, 4, 4, 4, 3))
    links = wilson.random_links_np(63, mesh)
    rng = np.random.default_rng(64)
    t, z, y, x = mesh.spacetime_dims
    return mesh, links, _cz(rng, (4, 3, t, z, y * x))


def test_mu_major_plain_matches_pallas_blocked_kernel(mu_problem):
    mesh, links, psi = mu_problem
    jmesh = JMesh(mesh.dims)
    jd = PallasWilsonDirac.build(_jcf(links, jnp.float32), jmesh, tb=2, zb=8, interpret=True,
                                 antiperiodic_t=True)
    want = jcplx.to_numpy(jd.apply(_jcf(psi, jnp.float32)))
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, device="cpu", tb=2, zb=8)
    assert not d.t_major and d.links.shape == (4, 3, 3, 4, 16, 16) and not d.anti_t
    np.testing.assert_array_equal(cplx.to_numpy(d.links), jcplx.to_numpy(jd.links))
    got = d.apply(cplx.from_numpy(psi, torch.float32, "cpu"))
    assert dslash_mu.launches == 0  # CPU tensors never launch the kernel
    _close(cplx.to_numpy(got), want, 1e-5)


def test_mu_major_operator_matches_t_major(mu_problem):
    mesh, links, psi = mu_problem
    x = cplx.from_numpy(psi, torch.float64, "cpu")
    kt = torch.tensor(K + 0.02j, dtype=torch.complex128)
    ops = [CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                                 device="cpu", **blocks)
           for blocks in ({}, {"tb": 2}, {"zb": 4})]
    assert [d.t_major for d in ops] == [True, False, False]
    want = cplx.to_numpy(ops[0].apply_dirac(x, kt))
    for d in ops[1:]:
        _close(cplx.to_numpy(d.apply_dirac(x, kt)), want, 1e-12)
    with pytest.raises(ValueError, match="compression"):
        CudaWilsonDirac.build(links, mesh, compress=True, device="cpu", tb=2)
    with pytest.raises(ValueError, match="divide"):
        CudaWilsonDirac.build(links, mesh, device="cpu", tb=3)


def test_mu_major_fused_solve_matches_jax():
    mesh = LatticeMesh((4, 4, 4, 4, 4, 3))
    links = wilson.random_links_np(65, mesh)
    rng = np.random.default_rng(66)
    rhs = _cz(rng, (4, 3, 4, 4, 16))
    jd = TpuWilsonDirac.build(_jcf(antiperiodic_t(links)), JMesh(mesh.dims))
    ja = JDirac(jd, jcplx.from_scalar(K, jnp.float64))
    want = j_gcr_solve(ja, _jcf(rhs), JParams(tol=1e-10, max_iter=200, restart=5))
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                              device="cpu", tb=2, zb=2)
    a = DiracOperator(d, K)
    # mu-major links never reach the one-pass steps, which read t-major strides
    assert _mega_step_config(a, None) is None and _z_step_config(a) is None
    got = gcr_solve(a, cplx.from_numpy(rhs, torch.float64, "cpu"),
                    GCRParams(tol=1e-10, max_iter=200, restart=5, fused=True))
    assert got.converged and got.n_iters == int(want.n_iters)
    n = got.n_iters + 1
    np.testing.assert_allclose(got.res_history.numpy()[:n], np.asarray(want.res_history)[:n],
                               rtol=1e-10, atol=1e-13)
    _close(cplx.to_numpy(got.x), jcplx.to_numpy(want.x), 1e-10)
