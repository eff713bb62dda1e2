"""Port parity for the even-odd decomposition and the Schur solve, f64, on
the (4, 4, 2, 8) lattice of tests/test_eo.py, against the JAX package on
inputs made with numpy from a seed (the MG over the Schur system:
test_torch_eo_mg.py).

- ``field_to_eo`` / ``field_from_eo`` equal JAX's on fields and links
  (exact), round-trip exactly, and the even half holds exactly the even
  sites;
- ``apply_eo`` / ``apply_oe`` against JAX's and against the full stencil
  restricted by parity, to 1e-12 of scale;
- ``eo_solve``, generic and fused (the cycles form on half-size fields):
  JAX's iteration count, histories to rtol 1e-10 with atol 1e-13, x to
  1e-10 of scale, and x solves the full system;
- ``from_dirac`` on 3-row t-major links with the in-kernel anti-periodic
  sign and on mu-major links (sign folded) gives the parity blocks of the
  anti-periodic operator (exact), as JAX's ``from_dirac`` does, and
  refuses two-row links.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.eo import EvenOddWilson as JEvenOdd
from mgpgcr_tpu.ops.eo import field_to_eo as j_field_to_eo
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac, links_to_tpu
from mgpgcr_tpu.solvers.eo import eo_solve as j_eo_solve
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    EvenOddWilson,
    GCRParams,
    LatticeMesh,
    SlabWilsonDirac,
    cplx,
    eo_solve,
    field_from_eo,
    field_to_eo,
    make_schur,
)
from mgpgcr_tpu_torch.ops.wilson import antiperiodic_t, random_links_np
from mgpgcr_tpu_torch.ops.wilson_slab import links_to_slab

DIMS = (4, 4, 2, 8, 4, 3)
K = 0.12


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


def _jcf(z):
    return jcplx.CF(jnp.asarray(z.real), jnp.asarray(z.imag))


def _field(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(scope="module")
def problem():
    mesh = LatticeMesh(DIMS)
    links = random_links_np(31, mesh)
    jmesh = JMesh(DIMS)
    jlinks = links_to_tpu(_jcf(links), jmesh)
    slab = links_to_slab(cplx.from_numpy(links, torch.float64, "cpu"), mesh)
    full = SlabWilsonDirac(slab, mesh)
    return dict(mesh=mesh, links=links, jmesh=jmesh, jeo=JEvenOdd.from_full(jlinks, jmesh),
                jfull=TpuWilsonDirac(jlinks, jmesh), full=full,
                eo=EvenOddWilson.from_full(slab, mesh), psi=_field(32, full.field_shape))


def test_split_matches_jax(problem):
    mesh, psi = problem["mesh"], problem["psi"]
    e, o = field_to_eo(cplx.from_numpy(psi, torch.float64, "cpu"), mesh)
    je, jo = j_field_to_eo(_jcf(psi), problem["jmesh"])
    assert e.shape == (4, 3, 4, 4, 8)
    np.testing.assert_array_equal(cplx.to_numpy(e), jcplx.to_numpy(je))
    np.testing.assert_array_equal(cplx.to_numpy(o), jcplx.to_numpy(jo))
    back = field_from_eo(e, o, mesh)
    np.testing.assert_array_equal(cplx.to_numpy(back), psi)
    # on links (leading axes) and on complex tensors
    eo, jeo = problem["eo"], problem["jeo"]
    np.testing.assert_array_equal(cplx.to_numpy(eo.links_e), jcplx.to_numpy(jeo.links_e))
    np.testing.assert_array_equal(cplx.to_numpy(eo.links_o), jcplx.to_numpy(jeo.links_o))
    te, to = field_to_eo(torch.as_tensor(psi), mesh)
    np.testing.assert_array_equal(field_from_eo(te, to, mesh).numpy(), psi)
    # the even half holds exactly the even sites
    t, z, y, xx = mesh.spacetime_dims
    par = np.indices((t, z, y, xx)).sum(0).reshape(t, z, y * xx) % 2
    only_even = np.where(par == 1, 0, psi)
    e2, o2 = field_to_eo(torch.as_tensor(only_even), mesh)
    assert float(o2.abs().max()) == 0.0 and float(e2.abs().max()) > 0.0


@pytest.mark.parametrize("parity_out", [0, 1])
def test_parity_blocks_match(problem, parity_out):
    mesh, psi, eo = problem["mesh"], problem["psi"], problem["eo"]
    t, z, y, xx = mesh.spacetime_dims
    par = np.indices((t, z, y, xx)).sum(0).reshape(t, z, y * xx) % 2
    src = np.where(par == 1 - parity_out, psi, 0)  # the input parity only
    s_e, s_o = field_to_eo(cplx.from_numpy(src, torch.float64, "cpu"), mesh)
    if parity_out == 0:
        got = eo.apply_eo(s_o)
        want = problem["jeo"].apply_eo(j_field_to_eo(_jcf(src), problem["jmesh"])[1])
    else:
        got = eo.apply_oe(s_e)
        want = problem["jeo"].apply_oe(j_field_to_eo(_jcf(src), problem["jmesh"])[0])
    _close(cplx.to_numpy(got), jcplx.to_numpy(want))
    full = problem["full"].apply(cplx.from_numpy(src, torch.float64, "cpu"))
    _close(cplx.to_numpy(got), cplx.to_numpy(field_to_eo(full, mesh)[parity_out]))


SOLVE = dict(tol=1e-10, max_iter=300, restart=10)


@pytest.fixture(scope="module")
def jax_solve(problem):
    """JAX's Schur solve, computed once for both forms of the port's."""
    b = _field(33, problem["full"].field_shape)
    return b, j_eo_solve(problem["jeo"], jcplx.from_scalar(K, jnp.float64), _jcf(b),
                         JGCRParams(**SOLVE))


@pytest.mark.parametrize("fused", [False, True])
def test_eo_solve_matches_jax(problem, jax_solve, fused):
    mesh, eo = problem["mesh"], problem["eo"]
    b, want = jax_solve
    got = eo_solve(eo, K, cplx.from_numpy(b, torch.float64, "cpu"),
                   GCRParams(fused=fused, **SOLVE))
    assert got.converged and got.n_iters == int(want.n_iters)
    n = got.n_iters + 1
    np.testing.assert_allclose(got.history_list()[:n], np.asarray(want.res_history)[:n],
                               rtol=1e-10, atol=1e-13)
    _close(cplx.to_numpy(got.x), jcplx.to_numpy(want.x), 1e-10)
    r = cplx.from_numpy(b, torch.float64, "cpu") - DiracOperator(problem["full"], K).apply(got.x)
    assert float(torch.sqrt(cplx.abs2_sum(r))) <= 1e-9 * np.linalg.norm(b)
    assert make_schur(eo, K, torch.float64).shape == (mesh.size // 2, mesh.size // 2)


@pytest.mark.parametrize("storage", ["t_major", "mu_major"])
def test_from_dirac_antiperiodic(problem, storage):
    mesh, links = problem["mesh"], problem["links"]
    extra = {} if storage == "t_major" else {"tb": 2}
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                              device="cpu", **extra)
    assert d.t_major == (storage == "t_major") and d.anti_t == (storage == "t_major")
    eo = EvenOddWilson.from_dirac(d)
    ap = antiperiodic_t(links)
    want = EvenOddWilson.from_full(links_to_slab(cplx.from_numpy(ap, torch.float64, "cpu"),
                                                 mesh), mesh)
    jeo = JEvenOdd.from_dirac(TpuWilsonDirac.build(_jcf(ap), problem["jmesh"]))
    for got, ref, jref in ((eo.links_e, want.links_e, jeo.links_e),
                           (eo.links_o, want.links_o, jeo.links_o)):
        np.testing.assert_array_equal(cplx.to_numpy(got), cplx.to_numpy(ref))
        np.testing.assert_array_equal(cplx.to_numpy(got), jcplx.to_numpy(jref))
    # the reconstructed x solves the anti-periodic system it was asked for
    b = cplx.from_numpy(_field(36, d.field_shape), torch.float64, "cpu")
    res = eo_solve(eo, K, b, GCRParams(tol=1e-10, max_iter=300, restart=10, fused=True))
    r = b - DiracOperator(d, K).apply(res.x)
    assert float(torch.sqrt(cplx.abs2_sum(r) / cplx.abs2_sum(b))) < 1e-9


def test_from_dirac_refuses_two_row_links(problem):
    d = CudaWilsonDirac.build(problem["links"], problem["mesh"], compress=True, device="cpu")
    with pytest.raises(ValueError, match="3-row"):
        EvenOddWilson.from_dirac(d)
