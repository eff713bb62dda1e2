"""Port parity for the block-stencil and block-ELL operators and the plain
version of kernel B12 (``stencil_spmv``), against the JAX package on
inputs made with numpy from a seed.

- ``stencil_neighbor_table`` equals JAX's (exact), and ``BlockMap``'s on
  the block grid;
- ``detect_block_stencil`` round-trips the blocks (exact) and rejects a
  coupling outside the stencil, as JAX's does;
- B12's plain version against ``stencil_spmv(..., interpret=True)`` at dims
  (4, 2, 4, 2), ne 3: f64 blocks to 1e-12 of scale, bf16 blocks (widened
  exactly on both sides, f32 arithmetic) to 1e-5 of scale; one compiled
  Pallas program per dtype;
- ``StencilBlockOperator.apply`` and ``_apply_xla`` and
  ``BlockSparseOperator.apply``, ``val_at`` and ``to_dense`` against
  JAX's, f64, to 1e-12 of scale, with a batch of fields and the duplicate
  slots of a 2-extent dim;
- ``DenseOperator``'s algebra (``val_at``, ``+``, ``-``, ``matmul``,
  ``dagger``) and ``FunctionOperator`` against JAX's, f64, to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.ops.blockstencil import StencilBlockOperator as JStencil
from mgpgcr_tpu.ops.blockstencil import detect_block_stencil as j_detect
from mgpgcr_tpu.ops.blockstencil import stencil_neighbor_table as j_table
from mgpgcr_tpu.ops.base import FunctionOperator as JFunction
from mgpgcr_tpu.ops.bsr import BlockSparseOperator as JBsr
from mgpgcr_tpu.ops.dense import DenseOperator as JDense
from mgpgcr_tpu.ops.pallas.spmv import stencil_spmv as j_stencil_spmv
from mgpgcr_tpu_torch import DenseOperator, FunctionOperator, LatticeMesh, cplx
from mgpgcr_tpu_torch.kernels.spmv import stencil_spmv, stencil_spmv_plain
from mgpgcr_tpu_torch.ops.blockstencil import (
    StencilBlockOperator,
    detect_block_stencil,
    stencil_neighbor_table,
)
from mgpgcr_tpu_torch.ops.bsr import BlockSparseOperator

DIMS, NE = (4, 2, 4, 2), 3


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _stencil(dims, ne, seed):
    """Random blocks with the duplicate slots of short dims zeroed, and the
    dense matrix they define."""
    rng = np.random.default_rng(seed)
    nb, k = int(np.prod(dims)), 2 * len(dims) + 1
    blocks = rng.standard_normal((nb, k, ne, ne)) + 1j * rng.standard_normal((nb, k, ne, ne))
    table = j_table(dims)
    for r in range(nb):
        seen = set()
        for j in range(k):
            if int(table[r, j]) in seen:
                blocks[r, j] = 0.0
            seen.add(int(table[r, j]))
    dense = np.zeros((nb * ne, nb * ne), complex)
    for r in range(nb):
        for j in range(k):
            c = int(table[r, j])
            dense[r * ne:(r + 1) * ne, c * ne:(c + 1) * ne] += blocks[r, j]
    return blocks, dense


def _vec(n, seed, lead=()):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(lead + (n,)) + 1j * rng.standard_normal(lead + (n,))


@pytest.mark.parametrize("dims", [DIMS, (3,), (2, 5), (1, 2, 3)], ids=str)
def test_neighbor_table_matches_jax(dims):
    np.testing.assert_array_equal(stencil_neighbor_table(dims), j_table(dims))


def test_neighbor_table_is_the_block_maps():
    bm = LatticeMesh((8, 4, 8, 4, 4, 3)).blocking(2)
    np.testing.assert_array_equal(stencil_neighbor_table(bm.blocks_per_dim), bm.neighbor_table())


def test_detection_roundtrip_and_rejection():
    dims, ne = (2, 2, 2, 2), 2
    blocks, dense = _stencil(dims, ne, 3)
    got = detect_block_stencil(sp.csr_matrix(dense), dims, ne)
    np.testing.assert_array_equal(got, j_detect(sp.csr_matrix(dense), dims, ne))
    np.testing.assert_allclose(got, blocks, rtol=0, atol=1e-14)
    bad = dense.copy()
    bad[0, -1] += 1.0  # a coupling to the far corner: no slot holds it
    assert detect_block_stencil(sp.csr_matrix(bad), dims, ne) is None
    assert j_detect(sp.csr_matrix(bad), dims, ne) is None
    assert detect_block_stencil(sp.csr_matrix(dense[:-1, :-1]), dims, ne) is None


@pytest.mark.parametrize("dtype", ["f64", "bf16"])
def test_spmv_plain_matches_pallas_interpret(dtype):
    blocks, _ = _stencil(DIMS, NE, 0)
    x = _vec(blocks.shape[0] * NE, 1)
    if dtype == "f64":
        jb, jx = jcplx.from_numpy(blocks, jnp.float64), jcplx.from_numpy(x, jnp.float64)
        tb, tx = cplx.from_numpy(blocks, torch.float64, "cpu"), cplx.from_numpy(x, torch.float64, "cpu")
        tol = 1e-12
    else:
        # bf16 storage: both sides widen the same rounded blocks to f32
        tb = cplx.from_numpy(blocks, torch.float32, "cpu").astype(torch.bfloat16)
        wide = cplx.to_numpy(tb.astype(torch.float32))
        jb = jcplx.CF(jnp.asarray(wide.real, jnp.bfloat16), jnp.asarray(wide.imag, jnp.bfloat16))
        jx, tx = jcplx.from_numpy(x, jnp.float32), cplx.from_numpy(x, torch.float32, "cpu")
        tol = 1e-5
    want = jcplx.to_numpy(j_stencil_spmv(jb, jx, DIMS, interpret=True))
    got = stencil_spmv(tb, tx, DIMS)  # CPU tensors: the plain version
    assert got.dtype == tx.dtype
    _close(cplx.to_numpy(got), want, tol)
    _close(cplx.to_numpy(stencil_spmv_plain(tb, tx, DIMS)), want, tol)


@pytest.mark.parametrize("dims", [DIMS, (2, 2, 2, 2), (5, 3)], ids=str)
def test_stencil_operator_matches_jax(dims):
    blocks, dense = _stencil(dims, NE, 4)
    xb = _vec(dense.shape[0], 5, lead=(2,))
    jop = JStencil(jnp.asarray(blocks), dims)
    op = StencilBlockOperator(torch.as_tensor(blocks), dims)
    assert op.shape == jop.shape and op.ne == jop.ne and op.n_blocks == jop.n_blocks
    want = np.asarray(jop.apply(jnp.asarray(xb)))
    _close(want, xb @ dense.T, 1e-12)
    xt = cplx.from_numpy(xb, torch.float64, "cpu")
    _close(cplx.to_numpy(op._apply_xla(xt)), want, 1e-12)
    for i in range(2):  # apply takes one field, a CF or a complex tensor
        _close(cplx.to_numpy(op.apply(xt[i])), want[i], 1e-12)
        _close(op.apply(torch.as_tensor(xb[i])).numpy(), want[i], 1e-12)
    lo = op.with_block_dtype(torch.bfloat16)
    assert lo.blocks.dtype == torch.bfloat16 and lo.dims == op.dims


def test_block_sparse_operator_matches_jax():
    blocks, dense = _stencil(DIMS, NE, 6)
    table = j_table(DIMS)
    xb = _vec(dense.shape[0], 7, lead=(2,))
    jop = JBsr(jnp.asarray(blocks), jnp.asarray(table))
    op = BlockSparseOperator(torch.as_tensor(blocks), table)
    assert op.shape == jop.shape and op.dim == dense.shape[0]
    want = np.asarray(jop.apply(jnp.asarray(xb)))
    _close(op.apply(torch.as_tensor(xb)).numpy(), want, 1e-12)
    _close(cplx.to_numpy(op.apply(cplx.from_numpy(xb, torch.float64, "cpu"))), want, 1e-12)
    _close(op.to_dense().numpy(), np.asarray(jop.to_dense()), 1e-12)
    rng = np.random.default_rng(8)
    for row, col in rng.integers(0, dense.shape[0], size=(6, 2)):
        assert abs(op.val_at(row, col) - jop.val_at(row, col)) <= 1e-12 * np.abs(blocks).max()
    # CF blocks are taken as complex ones
    cf = BlockSparseOperator(cplx.from_numpy(blocks, torch.float64, "cpu"), table)
    _close(cf.to_dense().numpy(), dense, 1e-12)


def test_dense_algebra_and_function_operator_match_jax():
    rng = np.random.default_rng(9)
    m1, m2 = (rng.standard_normal((6, 6)) + 1j * rng.standard_normal((6, 6)) for _ in range(2))
    x = _vec(6, 10)
    j1, j2 = JDense(jnp.asarray(m1)), JDense(jnp.asarray(m2))
    t1, t2 = DenseOperator(torch.as_tensor(m1)), DenseOperator(torch.as_tensor(m2))
    assert t1.dim == j1.dim == 6
    assert t1.val_at(2, 4) == complex(j1.val_at(2, 4))
    for got, want in ((t1 + t2, j1 + j2), (t1 - t2, j1 - j2), (t1.matmul(t2), j1.matmul(j2)),
                      (t1.dagger(), j1.dagger())):
        _close(got.a.numpy(), np.asarray(want.a), 1e-12)
        _close(got.apply(torch.as_tensor(x)).numpy(), np.asarray(want.apply(jnp.asarray(x))),
               1e-12)
    f = FunctionOperator(lambda v: 2.0 * v, 6)
    jf = JFunction(lambda v: 2.0 * v, 6)
    assert f.shape == jf.shape and f.dim == 6
    _close(f(torch.as_tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x))), 1e-12)
