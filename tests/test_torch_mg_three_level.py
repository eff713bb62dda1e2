"""Port parity for the MG hierarchy with n_level = 3 (block-stencil coarse
operators at both coarse levels, the flat layout below the first level).
float64, 4^4 lattice, k = 0.12, anti-periodic t, block 2 and coarse block
2, 2 null vectors (ne = 4): level 2 lives on (2, 2, 2, 2) blocks of 4 dof,
level 3 on one block.

The JAX side is ``mgpgcr_tpu.solvers.mg.setup_mg(layout="tpu")`` on
``TpuWilsonDirac`` with the XLA forms (``transfer_backend="xla"``, the XLA
block-stencil apply); the port runs the plain versions of its kernels (B10,
B11, B12 and the fused GCR algebra) on CPU tensors. The JAX setup compiles
for ~25 s on one core, so this file holds the three-level tests only; the
other MG tests are in test_torch_mg_levels.py.

- The setup from JAX's start vectors (one per level): the bases and the
  coarse blocks of levels 1 and 2 agree to 1e-10 of scale.
- The apply on JAX's hierarchy carried across by ``mg_from_numpy``, the
  deflation form at both levels (each coarse GCR preconditioned by the
  next level), equals the JAX apply to 1e-10 of scale.
- The level-2 smoother, the fused GCR(4) on flat (64,) CF vectors with the
  level-1 block-stencil operator, equals the JAX generic GCR(4) on the
  same operator to 1e-10 of scale.
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
from mgpgcr_tpu.solvers.gcr import gcr_solve as j_gcr_solve
from mgpgcr_tpu.solvers.mg import setup_mg as j_setup_mg
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu.solvers.params import MGParams as JMGParams
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
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.ops.blockstencil import StencilBlockOperator
from mgpgcr_tpu_torch.solvers.mg import setup_mg_from

DIMS = (4, 4, 4, 4)
K = 0.12
SMOOTHER = dict(tol=0.0, max_iter=4, restart=4)
# no repeated inverse-power solves for the first null vector: their JAX
# program (a GCR with x0) compiles for ~8 s per level on one core; the
# second vector's solve still runs at both levels
LEVELS = dict(block=2, n_nullvecs=2, n_level=3, coarse_block=2, coarse_format="stencil",
              setup_power_iters=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of small ops on 4^4 tensors: one intra-op thread is faster
    there, and leaves the cores to the test workers beside this one."""
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


def _tcf(z):
    return cplx.from_numpy(z, torch.float64, "cpu")


@pytest.fixture(scope="module")
def hier():
    """One three-level JAX setup, the start vectors it drew, and the port's
    operator on the same links."""
    mesh = LatticeMesh((*DIMS, 4, 3))
    jmesh = JMesh(mesh.dims)
    links = wilson.random_links_np(71, mesh)
    jd = TpuWilsonDirac.build(_jcf(antiperiodic_t(links)), jmesh)
    ja = JDirac(jd, jcplx.from_scalar(K, jnp.float64))
    jparams = JMGParams(transfer_backend="xla", smoother_gcr=JGCRParams(**SMOOTHER), **LEVELS)
    key = jax.random.PRNGKey(3)
    jmgp = j_setup_mg(key, ja, jmesh, jparams, layout="tpu")
    # setup_mg's start vectors: level 1 from the key, level 2 from its split
    b0 = [jcplx.to_numpy(jcplx.random(key, jd.field_shape, jnp.float64)),
          jcplx.to_numpy(jcplx.random(jax.random.split(key)[1], (jmgp.coarse.shape[0],),
                                      jnp.float64))]
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                              device="cpu")
    params = MGParams(smoother_gcr=GCRParams(fused=True, **SMOOTHER), **LEVELS)
    rng = np.random.default_rng(72)
    rhs = rng.standard_normal(jd.field_shape) + 1j * rng.standard_normal(jd.field_shape)
    return dict(mesh=mesh, jparams=jparams, jmgp=jmgp, b0=b0, a=DiracOperator(d, K),
                params=params, rhs=rhs)


def _stencil_np(op):
    return jcplx.to_numpy(op.blocks), tuple(op.dims)


def test_three_level_setup_matches_jax(hier):
    j, a = hier["jmgp"], hier["a"]
    mgp = setup_mg_from([_tcf(b) for b in hier["b0"]], a, hier["mesh"], hier["params"])
    assert isinstance(mgp.coarse, StencilBlockOperator) and mgp.coarse.dims == (2, 2, 2, 2)
    _close(cplx.to_numpy(mgp.q_field), jcplx.to_numpy(j.q_field), 1e-10)
    _close(cplx.to_numpy(mgp.coarse.blocks), jcplx.to_numpy(j.coarse.blocks), 1e-10)
    lv2, jlv2 = mgp.coarse_precond, j.coarse_precond
    assert lv2.layout == "flat" and lv2.coarse_precond is None and jlv2.coarse_precond is None
    assert lv2.block_map.mesh.dims == (2, 2, 2, 2, 4) and lv2.coarse.dims == (1, 1, 1, 1)
    _close(cplx.to_numpy(lv2.q), jcplx.to_numpy(jlv2.q), 1e-10)
    _close(cplx.to_numpy(lv2.coarse.blocks), jcplx.to_numpy(jlv2.coarse.blocks), 1e-10)
    with pytest.raises(ValueError, match="start vector for level 2"):
        setup_mg_from(_tcf(hier["b0"][0]), a, hier["mesh"], hier["params"])


def test_three_level_apply_matches_jax(hier):
    j = hier["jmgp"]
    jparams = dataclasses.replace(hier["jparams"], smoother_gcr=None)
    j = dataclasses.replace(j, params=jparams,
                            coarse_precond=dataclasses.replace(j.coarse_precond, params=jparams))
    params = dataclasses.replace(hier["params"], smoother_gcr=None)
    carried = mg_from_numpy(
        hier["a"], hier["mesh"], jcplx.to_numpy(j.q_field), _stencil_np(j.coarse), params,
        device="cpu",
        coarse_levels=[(jcplx.to_numpy(j.coarse_precond.q), _stencil_np(j.coarse_precond.coarse))],
    )
    assert carried.coarse_precond.layout == "flat" and carried.coarse_precond.coarse_precond is None
    want = j.apply(_jcf(hier["rhs"]))
    _close(cplx.to_numpy(carried.apply(_tcf(hier["rhs"]))), jcplx.to_numpy(want), 1e-10)


def test_level_two_smoother_matches_jax(hier):
    j = hier["jmgp"]
    op = StencilBlockOperator(torch.as_tensor(jcplx.to_numpy(j.coarse.blocks)), j.coarse.dims)
    rng = np.random.default_rng(73)
    b = rng.standard_normal(op.shape[0]) + 1j * rng.standard_normal(op.shape[0])
    want = j_gcr_solve(j.coarse, _jcf(b), JGCRParams(**SMOOTHER))
    got = gcr_solve(op, _tcf(b), hier["params"].smoother_gcr)
    assert got.n_iters == int(want.n_iters) == 4
    _close(cplx.to_numpy(got.x), jcplx.to_numpy(want.x), 1e-10)
