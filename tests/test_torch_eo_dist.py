"""The port's even-odd Schur solve on (t, z) shards (``solvers/eo.py::
eo_sharded``, ``eo_solve_grid``) against the single-device ``eo_solve``
and the JAX package's ``eo_solve``. float64, CPU, 4^4 lattice, k = 0.12,
anti-periodic t (3-row t-major links, the sign folded by ``from_dirac``),
the fused restart-5 Schur GCR to 1e-10. Ranks are threads (``ThreadComm``)
of a (2, 2) grid: 2x2x4x4 shards, so every shard starts at even t and z.

- The sharded solve takes the iterations of the single-device
  ``eo_solve`` and of JAX's ``eo_solve`` (on ``EvenOddWilson.from_full``
  of the same links), its gathered x within 1e-10 of scale of both.
- ``eo_field_sharding`` cuts full and compact parity fields alike.
- Odd local T or Z extents raise: the parity of a shard's sites would not
  be the global one.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.eo import EvenOddWilson as JEvenOdd
from mgpgcr_tpu.ops.wilson import antiperiodic_t as j_antiperiodic_t
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu.solvers.eo import eo_solve as j_eo_solve
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    EvenOddWilson,
    GCRParams,
    LatticeMesh,
    cplx,
    eo_field_sharding,
    eo_sharded,
    eo_solve,
    eo_solve_grid,
    make_shard_grid,
    run_spmd,
)
from mgpgcr_tpu_torch.ops.wilson import random_links_np

K = 0.12
PARAMS = dict(tol=1e-10, max_iter=200, restart=5)


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
    mesh = LatticeMesh((4, 4, 4, 4, 4, 3))
    links = random_links_np(3, mesh)
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                              device="cpu")
    b = np.random.default_rng(8).standard_normal((2,) + d.field_shape)
    return mesh, links, EvenOddWilson.from_dirac(d), b[0] + 1j * b[1]


def test_sharded_schur_solve_matches(problem):
    mesh, links, eo, b = problem
    rhs = cplx.from_numpy(b, torch.float64, "cpu")
    ref = eo_solve(eo, K, rhs, GCRParams(**PARAMS, fused=True))
    res = eo_solve_grid(eo, K, rhs, GCRParams(**PARAMS, fused=True),
                        make_shard_grid((2, 2), ("t", "z"), device="cpu"))
    assert ref.converged and res.converged and res.n_iters == ref.n_iters
    x, x_ref = cplx.to_numpy(res.x), cplx.to_numpy(ref.x)
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()

    jm = JMesh(mesh.dims)
    jd = TpuWilsonDirac.build(jcplx.ascf(jnp.asarray(j_antiperiodic_t(links)), jnp.float64), jm)
    jres = j_eo_solve(JEvenOdd.from_full(jd.links, jm), jcplx.from_scalar(K, jnp.float64),
                      jcplx.ascf(jnp.asarray(b), jnp.float64), JGCRParams(**PARAMS))
    assert int(jres.n_iters) == res.n_iters
    xj = jcplx.to_numpy(jres.x)
    assert np.abs(x - xj).max() <= 1e-10 * np.abs(xj).max()


def test_field_sharding_cuts_full_and_half_fields(problem):
    mesh, _, eo, b = problem
    grid = make_shard_grid((2, 2), ("t", "z"), device="cpu")
    full = cplx.from_numpy(b, torch.float64, "cpu")
    half = cplx.from_numpy(b[..., ::2], torch.float64, "cpu")

    def rank(comm):
        cut = eo_field_sharding(comm)
        t0, z0 = (c * 2 for c in comm.coords)
        assert torch.equal(cut(full).re, full.re[:, :, t0:t0 + 2, z0:z0 + 2])
        assert torch.equal(cut(half).im, half.im[:, :, t0:t0 + 2, z0:z0 + 2])
        local = eo_sharded(eo, comm)
        assert local.mesh.spacetime_dims == (2, 2, 4, 4) and local.field_shape == (4, 3, 2, 2, 8)

    run_spmd(grid, rank, timeout=60)


@pytest.mark.parametrize("sizes", [(4, 1), (1, 4)])
def test_odd_local_extents_raise(problem, sizes):
    _, _, eo, _ = problem
    with pytest.raises(ValueError, match="even local T and Z"):
        run_spmd(make_shard_grid(sizes, ("t", "z"), device="cpu"),
                 lambda comm: eo_sharded(eo, comm), timeout=60)
