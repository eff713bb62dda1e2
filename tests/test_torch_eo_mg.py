"""Port parity for the multigrid over the even-odd Schur system
(``setup_eo_mg``), f64, on the (4, 4, 2, 8) lattice of tests/test_eo.py.

From JAX's start vector, ``setup_mg_from`` on the Schur operator over the
half mesh with ``eo_mg_params`` (what ``setup_eo_mg`` runs), one null
vector and no power iterations (the start vector itself, chirally
doubled: the JAX side then compiles no GCR solve over its Schur operator,
which costs ~20 s on one core; the power iteration is the generic one of
test_torch_mg.py): the half mesh, the forced column assembly and dense
coarse operator, the (2, 2, 2, 1) half-mesh blocks, the field-shaped basis
and the coarse matrix against JAX's to 1e-12 of scale, and P^H S P = C.

The JAX setup takes ~16 s on one core (its start-vector draw and the
column assembly compile), so the MG-preconditioned Schur solve is held in
test_torch_eo_mg_solve.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.eo import EvenOddWilson as JEvenOdd
from mgpgcr_tpu.ops.wilson_tpu import links_to_tpu
from mgpgcr_tpu.solvers.eo import setup_eo_mg as j_setup_eo_mg
from mgpgcr_tpu.solvers.params import MGParams as JMGParams
from mgpgcr_tpu_torch import (
    EvenOddWilson,
    LatticeMesh,
    MGParams,
    cplx,
    eo_half_mesh,
    eo_mg_params,
    make_schur,
    setup_mg_from,
)
from mgpgcr_tpu_torch.ops.wilson import random_links_np
from mgpgcr_tpu_torch.ops.wilson_slab import links_to_slab

DIMS = (4, 4, 2, 8, 4, 3)
K = 0.19


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def test_setup_matches_jax():
    mesh = LatticeMesh(DIMS)
    links = random_links_np(31, mesh)
    eo = EvenOddWilson.from_full(
        links_to_slab(cplx.from_numpy(links, torch.float64, "cpu"), mesh), mesh)
    jmesh = JMesh(DIMS)
    jeo = JEvenOdd.from_full(links_to_tpu(jcplx.CF(jnp.asarray(links.real),
                                                   jnp.asarray(links.imag)), jmesh), jmesh)
    key = jax.random.PRNGKey(11)
    _, jmgp = j_setup_eo_mg(key, jeo, jcplx.from_scalar(K, jnp.float64),
                            JMGParams(block=2, n_nullvecs=1, setup_power_iters=0))
    mh = eo_half_mesh(mesh)
    assert mh.dims == (4, 4, 2, 4, 4, 3)
    b0 = jcplx.to_numpy(jcplx.random(key, (4, 3, 4, 4, 2 * 4), jnp.float64))
    s = make_schur(eo, K, torch.float64)
    mgp = setup_mg_from(cplx.from_numpy(b0, torch.float64, "cpu"), s, mh,
                        eo_mg_params(MGParams(block=2, n_nullvecs=1, setup_power_iters=0)))
    p = mgp.params
    assert (p.assembly, p.coarse_format, p.transfer_backend) == ("columns", "dense", "auto")
    assert mgp.block_map.mesh == mh and mgp.block_map.block_dims == (2, 2, 2, 1)
    _close(cplx.to_numpy(mgp.q_field), jcplx.to_numpy(jmgp.q_field))
    c = mgp.coarse.a.numpy()
    _close(c, jcplx.to_numpy(jmgp.coarse.a))
    rng = np.random.default_rng(34)
    vc = rng.standard_normal(c.shape[0]) + 1j * rng.standard_normal(c.shape[0])
    lhs = mgp.restrict(s.apply(mgp.prolong(cplx.from_numpy(vc, torch.float64, "cpu"))))
    _close(cplx.to_numpy(lhs), c @ vc, 1e-10)
    with pytest.raises(ValueError, match="even x block"):
        eo_mg_params(MGParams(block=(2, 2, 2, 3)))
