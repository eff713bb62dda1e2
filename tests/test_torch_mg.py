"""Port parity for the MG-preconditioned solve on slab fields, float64,
4^4 lattice, block 2, 2 null vectors (ne = 4), k = 0.12, anti-periodic t.

The JAX side is ``mgpgcr_tpu.solvers.mg.setup_mg(layout="tpu")`` on
``TpuWilsonDirac`` with the XLA forms (``transfer_backend="xla"``, the
generic GCR(4) smoother); its fused smoother and the Pallas transfers are
held to those forms by the JAX package's own tests and by
test_torch_gcr_kernels.py / test_torch_transfer.py. Each JAX program is
compiled once per module.

- Setup from the same start vector b0: null vectors, the field-shaped
  basis and the dense coarse matrix agree to 1e-9 of scale (f64; the
  power iteration's GCR solves run in another order); P^H P = I per block
  and P^H A P = C to 1e-10.
- Apply, on the JAX hierarchy carried across by ``mg_from_numpy``: the
  V-cycle with the GCR(4) smoother, the deflation-only form and the
  Neumann smoother equal the JAX apply to 1e-10 of scale.
- Whole path: the port's fused preconditioned restart cycles (update_r,
  the z-step, ap_update and basis_flush through their plain versions)
  against the JAX package's host-loop generic GCR (``gcr_solve_eager``)
  with the same preconditioner: same iteration count, histories to rtol
  1e-8, x to 1e-8 of scale. The port's loop form under ``unroll="auto"``
  (update_xr, the z-step, dir_update), with ``unroll="loop"`` on an
  operator without the z-step (update_xr, beta_dots, dir_update with r),
  its fused eager form and its generic form agree the same way.
"""

import dataclasses

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
from mgpgcr_tpu.solvers.gcr import _jit_bound_apply, gcr_solve_eager
from mgpgcr_tpu.solvers.mg import setup_mg as j_setup_mg
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu.solvers.params import MGParams as JMGParams
from mgpgcr_tpu.solvers.power import inverse_power_vectors as j_inverse_power_vectors
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    cplx,
    gcr_solve,
    mg_from_numpy,
)
from mgpgcr_tpu_torch import gcr_solve_eager as gcr_solve_eager_t
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.solvers.mg import _check_transfer_backend, setup_mg_from
from mgpgcr_tpu_torch.solvers.power import inverse_power_vectors

DIMS = (4, 4, 4, 4)
K = 0.12
SMOOTHER = dict(tol=0.0, max_iter=4, restart=4)
OUTER = dict(tol=1e-8, max_iter=60, restart=5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of small ops on 4^4 tensors: one
    intra-op thread is faster there than eight, and leaves the cores to
    the test workers running beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _jcf(z):
    return jcplx.CF(jnp.asarray(z.real), jnp.asarray(z.imag))


@pytest.fixture(scope="module")
def hier():
    """One JAX setup and the port's operator on the same links."""
    mesh = LatticeMesh((*DIMS, 4, 3))
    jmesh = JMesh(mesh.dims)
    links = wilson.random_links_np(51, mesh)
    jd = TpuWilsonDirac.build(_jcf(antiperiodic_t(links)), jmesh)
    ja = JDirac(jd, jcplx.from_scalar(K, jnp.float64))
    jparams = JMGParams(block=2, n_nullvecs=2, transfer_backend="xla",
                        smoother_gcr=JGCRParams(**SMOOTHER))
    key = jax.random.PRNGKey(3)
    jmgp = j_setup_mg(key, ja, jmesh, jparams, layout="tpu")
    # setup_mg's start vector, drawn the same way from the same key
    b0 = jcplx.to_numpy(jcplx.random(key, jd.field_shape, jnp.float64))
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                              device="cpu")
    params = MGParams(block=2, n_nullvecs=2,
                      smoother_gcr=GCRParams(fused=True, **SMOOTHER))
    rng = np.random.default_rng(52)
    rhs = rng.standard_normal(jd.field_shape) + 1j * rng.standard_normal(jd.field_shape)
    return dict(mesh=mesh, jmesh=jmesh, ja=ja, jparams=jparams, jmgp=jmgp, b0=b0,
                a=DiracOperator(d, K), params=params, rhs=rhs)


@pytest.fixture(scope="module")
def carried(hier):
    """The JAX hierarchy in the port, through ``mg_from_numpy``."""
    j = hier["jmgp"]
    return mg_from_numpy(hier["a"], hier["mesh"], jcplx.to_numpy(j.q_field),
                         jcplx.to_numpy(j.coarse.a), hier["params"], device="cpu")


def test_setup_matches_jax(hier):
    a, mesh, params = hier["a"], hier["mesh"], hier["params"]
    b0 = cplx.from_numpy(hier["b0"], torch.float64, "cpu")
    jp = hier["jparams"]
    want = j_inverse_power_vectors(hier["ja"], _jcf(hier["b0"]), 2, jp.setup_gcr,
                                   jp.setup_power_iters)
    got = inverse_power_vectors(a, b0, 2, params.setup_gcr, params.setup_power_iters)
    _close(cplx.to_numpy(got), jcplx.to_numpy(want), 1e-9)

    mgp = setup_mg_from(b0, a, mesh, params)
    j = hier["jmgp"]
    _close(cplx.to_numpy(mgp.q_field), jcplx.to_numpy(j.q_field), 1e-9)
    c = mgp.coarse.a.numpy()
    _close(c, jcplx.to_numpy(j.coarse.a), 1e-9)

    # P^H P = I per block, and P^H A P = C on random coarse vectors
    q = cplx.to_numpy(mgp.block_map.to_blocked_tpu(mgp.q_field))  # (ne, nb, bl)
    gram = np.einsum("ebk,fbk->bef", q.conj(), q)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(4), gram.shape), atol=1e-12)
    rng = np.random.default_rng(53)
    for _ in range(2):
        vc = rng.standard_normal(c.shape[0]) + 1j * rng.standard_normal(c.shape[0])
        lhs = mgp.restrict(a.apply(mgp.prolong(cplx.from_numpy(vc, torch.float64, "cpu"))))
        _close(cplx.to_numpy(lhs), c @ vc, 1e-10)


APPLY = {
    "gcr_smoother": {},
    "deflation": {"smoother_gcr": None},
    "neumann": {"smoother": "neumann"},
}
# the GCR-smoother apply is jitted as the whole-path solve jits it (one
# compile for both); the other two run eagerly, which compiles less


@pytest.mark.parametrize("name", sorted(APPLY))
def test_apply_matches_jax(hier, carried, name):
    jmgp = dataclasses.replace(
        hier["jmgp"], params=dataclasses.replace(hier["jparams"], **APPLY[name])
    )
    mgp = dataclasses.replace(carried, params=dataclasses.replace(carried.params, **APPLY[name]))
    japply = _jit_bound_apply(jmgp.apply) if name == "gcr_smoother" else jmgp.apply
    want = japply(_jcf(hier["rhs"]))
    got = mgp.apply(cplx.from_numpy(hier["rhs"], torch.float64, "cpu"))
    _close(cplx.to_numpy(got), jcplx.to_numpy(want), 1e-10)


def _history(res):
    if hasattr(res, "history_list"):
        return np.asarray(res.history_list())
    return np.asarray(res.res_history)


@pytest.fixture(scope="module")
def mg_want(hier):
    """The JAX package's MG-GCR, computed once for the whole-path tests."""
    return gcr_solve_eager(hier["ja"], _jcf(hier["rhs"]), JGCRParams(**OUTER),
                           precond=hier["jmgp"].apply)


def _check_against(got, want):
    assert got.converged and got.n_iters == int(want.n_iters)
    np.testing.assert_allclose(_history(got), _history(want), rtol=1e-8, atol=1e-13)
    _close(cplx.to_numpy(got.x), jcplx.to_numpy(want.x), 1e-8)


def test_mg_gcr_matches_jax(hier, carried, mg_want):
    b = cplx.from_numpy(hier["rhs"], torch.float64, "cpu")
    solves = {
        "cycles": gcr_solve(hier["a"], b, GCRParams(fused=True, unroll="cycles", **OUTER),
                            precond=carried.apply),
        # "auto" with a preconditioner: the loop form with the z-step
        "auto": gcr_solve(hier["a"], b, GCRParams(fused=True, **OUTER), precond=carried.apply),
        "eager": gcr_solve_eager_t(hier["a"], b, GCRParams(fused=True, **OUTER),
                                   precond=carried.apply),
        "generic": gcr_solve(hier["a"], b, GCRParams(**OUTER), precond=carried.apply),
        "eager_generic": gcr_solve_eager_t(hier["a"], b, GCRParams(**OUTER),
                                           precond=carried.apply),
    }
    assert bool(mg_want.converged) and int(mg_want.n_iters) > 1
    for got in solves.values():
        _check_against(got, mg_want)


def test_fused_preconditioned_needs_cycles(hier, carried, mg_want):
    """The loop form once refused here now runs a preconditioned fused
    solve without the cycles form: ``unroll="loop"`` on the operator passed
    as a function (no z-step), so each iteration is update_xr, M r, A z,
    beta_dots and dir_update dotted against r; it matches JAX."""
    b = cplx.from_numpy(hier["rhs"], torch.float64, "cpu")
    got = gcr_solve(hier["a"].apply, b, GCRParams(fused=True, unroll="loop", **OUTER),
                    precond=carried.apply)
    _check_against(got, mg_want)


def test_transfer_backend_other_than_auto_raises_on_cuda():
    """The port has one transfer route ("auto": the kernels for CUDA tensors,
    their plain versions for CPU tensors); another value is refused for
    CUDA tensors rather than switching the card to the plain versions."""
    _check_transfer_backend(MGParams(), "cuda")
    _check_transfer_backend(MGParams(transfer_backend="xla"), "cpu")
    with pytest.raises(ValueError, match="transfer_backend"):
        _check_transfer_backend(MGParams(transfer_backend="xla"), "cuda")
