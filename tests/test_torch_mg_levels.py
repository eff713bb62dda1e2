"""Port parity for the rest of the two-level MG: the dense, block-ELL and
block-stencil coarse operators, both assemblies, the flat layout and left
preconditioning. float64, 4^4 lattice, k = 0.12, anti-periodic t, block 2,
ne = 4. The JAX side uses the XLA forms (``TpuWilsonDirac``,
``transfer_backend="xla"``, the XLA block-stencil apply); the port's side
runs the plain versions of its kernels (B10, B11, B12 and the fused GCR
algebra) on CPU tensors. No JAX MG setup runs here (one compiles for ~35 s
on one core): the basis is a per-block orthonormal one from numpy, and
the coarse blocks are JAX's phase-probed Galerkin blocks of it. The
three-level hierarchy is held to JAX's in test_torch_mg_three_level.py.

- Assemblies on the slab layout: the port's phased blocks and column
  sweep equal JAX's phased blocks (and their dense form) to 1e-11 of
  scale.
- Coarse formats: the deflation-only apply (where the formats differ: the
  coarse GCR) with the dense, block-ELL and block-stencil coarse operators
  built from the same blocks equals the JAX apply in the same format to
  1e-10 of scale.
- Assembly on the canonical operator (``WilsonDiracOperator``, the flat
  layout, the first parameter set of tests/test_mg.py::
  test_phased_assembly_matches_column_sweep): the phased blocks equal
  JAX's, the column sweep equals their dense form, and the block-ELL
  extraction of the column sweep equals them, all to 1e-11 of scale.
- Flat layout: a setup on canonical fields builds the coarse operator of
  the slab setup from the same start vector (1e-9 of scale); P^H P = I,
  (P R)^2 = P R, R P = I and P^H A P = C in all three formats, to 1e-10;
  the column assembly refuses the stencil format, as JAX's does.
- The flat layout's pieces: ``BlockMap.to_blocked`` / ``from_blocked``
  on canonical fields with internal dims (4, 3) and (ne,),
  ``LatticeMesh.coords_to_index`` / ``index_to_coords``, and
  ``fields.normalize`` / ``gamma5`` / ``chiral_project`` / ``gram_schmidt``
  against JAX's (exact, or to 1e-12 of scale).
- Left preconditioning with the deflation-only MG apply (coarse GCR to
  1e-12, so the preconditioner is linear to round-off) and an x0: restart
  5 and truncation 3, generic and fused, against the JAX generic
  ``gcr_solve`` with the same M composed from the JAX transfers and an
  exact coarse solve: the same iteration count, histories to rtol 1e-8, x
  to 1e-8 of scale.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu import fields as jfields
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.wilson import WilsonDiracOperator as JWilson
from mgpgcr_tpu.ops.wilson import antiperiodic_t
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu.solvers.gcr import gcr_solve as j_gcr_solve
from mgpgcr_tpu.solvers.mg import MGPreconditioner as JMG
from mgpgcr_tpu.solvers.mg import block_orthonormalize as j_block_orthonormalize
from mgpgcr_tpu.solvers.mg import build_coarse_operator as j_build_coarse_operator
from mgpgcr_tpu.solvers.mg import galerkin_coarse_blocks as j_galerkin_coarse_blocks
from mgpgcr_tpu.solvers.mg import prolong_field as j_prolong_field
from mgpgcr_tpu.solvers.mg import restrict_field as j_restrict_field
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu.solvers.params import MGParams as JMGParams
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    cplx,
    fields,
    gcr_solve,
    mg_from_numpy,
)
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.ops.wilson_slab import field_to_slab
from mgpgcr_tpu_torch.solvers.mg import (
    blocks_to_dense,
    build_coarse_operator,
    coarse_to_block_ell,
    field_basis,
    galerkin_coarse_blocks,
    galerkin_coarse_matrix,
    setup_mg_from,
)

DIMS = (4, 4, 4, 4)
K = 0.12
NE = 4


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
def problem():
    """The operator on both sides, a per-block orthonormal basis from numpy
    (ne = 4, block 2) and the JAX package's phase-probed coarse blocks of
    it, computed once."""
    mesh = LatticeMesh((*DIMS, 4, 3))
    jmesh = JMesh(mesh.dims)
    links = wilson.random_links_np(71, mesh)
    ja = JDirac(TpuWilsonDirac.build(_jcf(antiperiodic_t(links)), jmesh),
                jcplx.from_scalar(K, jnp.float64))
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                              device="cpu")
    bm, jbm = mesh.blocking(2), jmesh.blocking(2)
    rng = np.random.default_rng(72)
    z = rng.standard_normal((bm.n_blocks, bm.block_len, NE)) + 1j * rng.standard_normal(
        (bm.n_blocks, bm.block_len, NE))
    q = np.linalg.qr(z)[0].transpose(2, 0, 1)  # (ne, nb, bl), orthonormal per block
    jblocks, jtable = j_galerkin_coarse_blocks(ja, _jcf(q), jbm, "tpu")
    rhs = rng.standard_normal((4, 3, 4, 4, 16)) + 1j * rng.standard_normal((4, 3, 4, 4, 16))
    return dict(mesh=mesh, jbm=jbm, links=links, ja=ja, a=DiracOperator(d, K), bm=bm, q=q,
                q_field=cplx.to_numpy(field_basis(_tcf(q), bm)), jblocks=jblocks,
                jtable=jtable, rhs=rhs)


def test_slab_assemblies_match_jax(problem):
    """The phase-probed blocks and the column sweep on the slab layout,
    with the transfers' plain versions, against JAX's phased blocks."""
    a, bm = problem["a"], problem["bm"]
    qf = _tcf(problem["q_field"])
    want = jcplx.to_numpy(problem["jblocks"])
    blocks, table = galerkin_coarse_blocks(a, qf, bm)
    _close(blocks.numpy(), want, 1e-11)
    np.testing.assert_array_equal(table, np.asarray(problem["jtable"]))
    c = galerkin_coarse_matrix(a, qf, bm, "tpu")
    _close(c.numpy(), blocks_to_dense(torch.as_tensor(want), table).numpy(), 1e-11)


def _jax_mg(problem, fmt):
    """The JAX package's two-level deflation-only MG on the fixture's basis
    and blocks."""
    params = JMGParams(block=2, n_nullvecs=NE // 2, coarse_format=fmt, transfer_backend="xla",
                       smoother_gcr=None)
    jbm = problem["jbm"]
    coarse = j_build_coarse_operator(problem["jblocks"], problem["jtable"], fmt,
                                     jbm.blocks_per_dim)
    return JMG(a=problem["ja"], q=_jcf(problem["q"]), coarse=coarse, block_map=jbm,
               params=params, layout="tpu", q_field=_jcf(problem["q_field"]))


def _port_coarse(problem, fmt):
    blocks = jcplx.to_numpy(problem["jblocks"])
    return {"dense": lambda: (blocks_to_dense(torch.as_tensor(blocks), problem["jtable"])
                              .numpy()),
            "bsr": lambda: (blocks, np.asarray(problem["jtable"])),
            "stencil": lambda: (blocks, problem["bm"].blocks_per_dim)}[fmt]()


@pytest.mark.parametrize("fmt", ["dense", "bsr", "stencil"])
def test_coarse_formats_match_jax(problem, fmt):
    """The deflation-only apply, where the formats differ (the coarse GCR),
    with each coarse format built from the same blocks."""
    jmgp = _jax_mg(problem, fmt)
    params = MGParams(block=2, n_nullvecs=NE // 2, coarse_format=fmt, smoother_gcr=None)
    mgp = mg_from_numpy(problem["a"], problem["mesh"], problem["q_field"],
                        _port_coarse(problem, fmt), params, device="cpu")
    assert type(mgp.coarse).__name__ == type(jmgp.coarse).__name__
    want = jcplx.to_numpy(jmgp.apply(_jcf(problem["rhs"])))
    _close(cplx.to_numpy(mgp.apply(_tcf(problem["rhs"]))), want, 1e-10)


def test_phased_equals_columns_on_canonical_operator():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = wilson.random_links_np(73, mesh)
    bm = mesh.blocking(2)
    rng = np.random.default_rng(0)
    ne = 3
    vecs = rng.standard_normal((ne, mesh.size)) + 1j * rng.standard_normal((ne, mesh.size))
    jmesh = JMesh(mesh.dims)
    ja = JDirac(JWilson(jnp.asarray(links), jmesh), jnp.asarray(0.1 + 0j))
    q = j_block_orthonormalize(jnp.asarray(vecs), jmesh.blocking(2))
    jblocks, jtable = j_galerkin_coarse_blocks(ja, q, jmesh.blocking(2))
    a = DiracOperator(wilson.WilsonDiracOperator(torch.as_tensor(links), mesh), 0.1)
    tq = _tcf(np.asarray(q))
    blocks, table = galerkin_coarse_blocks(a, tq, bm, "flat")
    _close(blocks.numpy(), np.asarray(jblocks), 1e-11)
    np.testing.assert_array_equal(table, np.asarray(jtable))
    c = galerkin_coarse_matrix(a, tq, bm, "flat")
    _close(blocks_to_dense(blocks, table).numpy(), c.numpy(), 1e-11)
    bsr = coarse_to_block_ell(c, bm, ne)
    _close(bsr.blocks.numpy(), np.asarray(jblocks), 1e-11)
    np.testing.assert_array_equal(bsr.block_cols.numpy(), np.asarray(jtable))


@pytest.mark.parametrize("dims,block", [((4, 2, 4, 2, 4, 3), (2, 1, 2, 2)),
                                         ((2, 2, 2, 2, 6), 2)], ids=str)
def test_flat_pieces_match_jax(dims, block):
    mesh, jmesh = LatticeMesh(dims, n_spacetime=4), JMesh(dims, n_spacetime=4)
    bm, jbm = mesh.blocking(block), jmesh.blocking(block)
    rng = np.random.default_rng(75)
    x = rng.standard_normal((2, mesh.size)) + 1j * rng.standard_normal((2, mesh.size))
    xb = bm.to_blocked(torch.as_tensor(x))
    np.testing.assert_array_equal(xb.numpy(), np.asarray(jbm.to_blocked(jnp.asarray(x))))
    np.testing.assert_array_equal(bm.from_blocked(xb).numpy(), x)
    assert np.array_equal(cplx.to_numpy(bm.to_blocked(_tcf(x))), xb.numpy())
    for idx in (0, 7, mesh.size - 1):
        assert mesh.index_to_coords(idx) == jmesh.index_to_coords(idx)
        assert mesh.coords_to_index(jmesh.index_to_coords(idx)) == idx
    if dims[-2:] != (4, 3):
        return
    v = torch.as_tensor(x)
    _close(fields.normalize(v[0]).numpy(), np.asarray(jfields.normalize(jnp.asarray(x[0]))), 1e-12)
    _close(cplx.to_numpy(fields.normalize(_tcf(x[0]))), np.asarray(jfields.normalize(
        jnp.asarray(x[0]))), 1e-12)
    np.testing.assert_array_equal(fields.gamma5(v, mesh).numpy(),
                                  np.asarray(jfields.gamma5(jnp.asarray(x), jmesh)))
    np.testing.assert_array_equal(cplx.to_numpy(fields.gamma5(_tcf(x), mesh)),
                                  np.asarray(jfields.gamma5(jnp.asarray(x), jmesh)))
    for sign in (1, -1):
        _close(fields.chiral_project(v, sign, mesh).numpy(),
               np.asarray(jfields.chiral_project(jnp.asarray(x), sign, jmesh)), 1e-12)
    want = np.asarray(jfields.gram_schmidt(jnp.asarray(x)))
    _close(fields.gram_schmidt(v).numpy(), want, 1e-12)
    _close(cplx.to_numpy(fields.gram_schmidt(_tcf(x))), want, 1e-12)


def test_flat_layout_setup_properties(problem):
    mesh, links = problem["mesh"], problem["links"]
    op = wilson.WilsonDiracOperator(torch.as_tensor(wilson.antiperiodic_t(links)), mesh)
    a = DiracOperator(op, K)
    params = MGParams(block=2, n_nullvecs=NE // 2, coarse_format="stencil", smoother_gcr=None)
    gen = torch.Generator().manual_seed(5)
    b0 = cplx.random(gen, (mesh.size,), torch.float64, "cpu")
    mgp = setup_mg_from(b0, a, mesh, params, layout="flat")
    assert mgp.layout == "flat" and mgp.q_field is None and mgp.q.shape == (NE, 16, 192)
    # the slab setup from the same start vector builds the same coarse operator
    slab = setup_mg_from(field_to_slab(b0, mesh), problem["a"], mesh, params)
    _close(cplx.to_numpy(mgp.coarse.blocks), cplx.to_numpy(slab.coarse.blocks), 1e-9)

    q = cplx.to_numpy(mgp.q)
    gram = np.einsum("ebk,fbk->bef", q.conj(), q)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(NE), gram.shape), atol=1e-12)
    v = cplx.random(gen, (mesh.size,), torch.float64, "cpu")
    pr = mgp.prolong(mgp.restrict(v))
    _close(cplx.to_numpy(mgp.prolong(mgp.restrict(pr))), cplx.to_numpy(pr), 1e-10)
    vc = cplx.random(gen, (mgp.coarse.shape[0],), torch.float64, "cpu")
    _close(cplx.to_numpy(mgp.restrict(mgp.prolong(vc))), cplx.to_numpy(vc), 1e-10)
    lhs = cplx.to_numpy(mgp.restrict(a.apply(mgp.prolong(vc))))
    cb = mgp.coarse.blocks
    blocks = torch.complex(cb.re, cb.im)
    table = mgp.block_map.neighbor_table()
    for fmt in ("dense", "bsr", "stencil"):
        coarse = build_coarse_operator(blocks, table, fmt, mgp.block_map.blocks_per_dim)
        _close(cplx.to_numpy(coarse.apply(vc)), lhs, 1e-10)
    with pytest.raises(ValueError, match="phased"):
        setup_mg_from(b0, a, mesh, dataclasses.replace(params, assembly="columns"),
                      layout="flat")


@pytest.fixture(scope="module")
def left(problem):
    """The deflation-only MG apply M = I + P C^-1 P^H on both sides, an x0,
    and the JAX package's left-preconditioned generic solves with restart 5
    and truncation 3. The port runs its MG apply with a coarse GCR to 1e-12;
    the JAX side composes the same M from its transfers (``restrict_field``,
    ``prolong_field``) and an exact coarse solve, which keeps the solves'
    programs small enough to compile in seconds."""
    blocks = _port_coarse(problem, "dense")
    params = MGParams(block=2, n_nullvecs=NE // 2, smoother_gcr=None,
                      coarse_gcr=GCRParams(tol=1e-12, max_iter=100))
    mgp = mg_from_numpy(problem["a"], problem["mesh"], problem["q_field"], blocks, params,
                        device="cpu")
    qf, jbm = _jcf(problem["q_field"]), problem["jbm"]
    cinv = jnp.asarray(np.linalg.inv(blocks))

    def jmg(v):
        rc = j_restrict_field(qf, jbm, v)
        ec = cinv @ (rc.re + 1j * rc.im)
        return v + j_prolong_field(qf, jbm, jcplx.CF(ec.real, ec.imag))

    rng = np.random.default_rng(74)
    shape = problem["rhs"].shape
    x0 = 0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    want = {kind: j_gcr_solve(problem["ja"], _jcf(problem["rhs"]),
                              JGCRParams(tol=1e-8, max_iter=80, **gp), x0=_jcf(x0),
                              left_precond=jmg)
            for kind, gp in GROWTH.items()}
    return mgp, x0, want


GROWTH = {"restart": dict(restart=5), "truncation": dict(truncation=3)}


@pytest.mark.parametrize("kind", sorted(GROWTH))
@pytest.mark.parametrize("fused", [False, True], ids=["generic", "fused"])
def test_left_precond_matches_jax(problem, left, kind, fused):
    mgp, x0, want = left
    want = want[kind]
    got = gcr_solve(problem["a"], _tcf(problem["rhs"]),
                    GCRParams(tol=1e-8, max_iter=80, fused=fused, **GROWTH[kind]),
                    x0=_tcf(x0), left_precond=mgp.apply)
    assert bool(want.converged) and int(want.n_iters) > 2
    assert got.converged and got.n_iters == int(want.n_iters)
    n = got.n_iters + 1
    np.testing.assert_allclose(got.res_history.numpy()[:n], np.asarray(want.res_history)[:n],
                               rtol=1e-8, atol=1e-13)
    _close(cplx.to_numpy(got.x), jcplx.to_numpy(want.x), 1e-8)
