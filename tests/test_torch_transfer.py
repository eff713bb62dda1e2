"""Port parity for the MG blocking and grid transfers: ``BlockMap`` against
the JAX package's, the plain versions of kernels B10 (restrict) and B11
(prolong) against ``mgpgcr_tpu.solvers.mg.restrict_field`` /
``prolong_field`` (float64, rtol 1e-12 of scale) and against the Pallas
kernels ``restrict_pallas`` / ``prolong_pallas`` in interpret mode
(float32, 1e-5 of scale; a bf16 basis is widened exactly on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.pallas.transfer import prolong_pallas, restrict_pallas
from mgpgcr_tpu.solvers.mg import prolong_field, restrict_field
from mgpgcr_tpu_torch import LatticeMesh, cplx
from mgpgcr_tpu_torch.kernels.transfer import prolong, restrict
from mgpgcr_tpu_torch.solvers.mg import field_basis

# (lattice, block): the main case and a non-cubic one with unequal blocks
CASES = {"4444_b2": ((4, 4, 4, 4), 2), "2428_b2214": ((2, 4, 2, 8), (2, 2, 1, 4))}
NE = 4


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _problem(name, seed=0):
    dims, block = CASES[name]
    mesh = LatticeMesh((*dims, 4, 3))
    bm = mesh.blocking(block)
    rng = np.random.default_rng(seed)

    def cz(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    q = cz(NE, bm.n_blocks, bm.block_len)
    fshape = (4, 3, dims[0], dims[1], dims[2] * dims[3])
    return mesh, bm, JMesh(mesh.dims).blocking(block), q, cz(*fshape), cz(bm.n_blocks * NE)


def _jcf(z, dt=jnp.float64):
    return jcplx.CF(jnp.asarray(z.real, dt), jnp.asarray(z.imag, dt))


def _tcf(z, dt=torch.float64):
    return cplx.from_numpy(z, dt, "cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_map_matches_jax(name):
    mesh, bm, jbm, q, x, _ = _problem(name)
    assert bm.blocks_per_dim == jbm.blocks_per_dim and bm.block_len == jbm.block_len
    np.testing.assert_array_equal(bm.neighbor_table(), jbm.neighbor_table())
    xb = bm.to_blocked_tpu(torch.as_tensor(x))
    assert np.array_equal(xb.numpy(), np.asarray(jbm.to_blocked_tpu(jnp.asarray(x))))
    assert torch.equal(bm.from_blocked_tpu(xb), torch.as_tensor(x))
    qf = field_basis(_tcf(q), bm)
    want = np.asarray(jax.vmap(jbm.from_blocked_tpu)(jnp.asarray(q)))
    assert np.array_equal(cplx.to_numpy(qf), want)
    # site_blocks: every site of block b holds b in the blocked layout
    sb = torch.as_tensor(bm.site_blocks()).expand((4, 3) + x.shape[2:])
    blocked = bm.to_blocked_tpu(sb)
    assert torch.equal(blocked, torch.arange(bm.n_blocks)[:, None].expand_as(blocked))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_transfers_match_jax_f64(name):
    _, bm, jbm, q, x, xc = _problem(name)
    qf = field_basis(_tcf(q), bm)
    jqf = jax.vmap(jbm.from_blocked_tpu)(_jcf(q))
    got = restrict(qf, bm, _tcf(x))
    _close(cplx.to_numpy(got), jcplx.to_numpy(restrict_field(jqf, jbm, _jcf(x))), 1e-12)
    got = prolong(qf, bm, _tcf(xc), _tcf(x), damping=0.7)
    want = _jcf(x) + jcplx.scale_real(prolong_field(jqf, jbm, _jcf(xc)), 0.7)
    _close(cplx.to_numpy(got), jcplx.to_numpy(want), 1e-12)


# each case is one interpret-mode compile of a few seconds
PALLAS = {
    "restrict_f32": ("restrict", torch.float32, None),
    "restrict_bf16": ("restrict", torch.bfloat16, None),
    "prolong_f32": ("prolong", torch.float32, None),
    "prolong_bf16": ("prolong", torch.bfloat16, None),
    "prolong_base_damped": ("prolong", torch.float32, 0.3),
}


@pytest.mark.parametrize("case", sorted(PALLAS))
def test_transfers_match_pallas_f32(case):
    op, qdt, damping = PALLAS[case]
    _, bm, jbm, q, x, xc = _problem("4444_b2", seed=1)
    jdt = jnp.bfloat16 if qdt == torch.bfloat16 else jnp.float32
    qf = field_basis(_tcf(q, torch.float32), bm).astype(qdt)
    jqf = jax.vmap(jbm.from_blocked_tpu)(_jcf(q, jnp.float32))
    jqf = jcplx.CF(jqf.re.astype(jdt), jqf.im.astype(jdt))
    if op == "restrict":
        got = restrict(qf, bm, _tcf(x, torch.float32))
        want = restrict_pallas(jqf, jbm, _jcf(x, jnp.float32))
    elif damping is None:
        got = prolong(qf, bm, _tcf(xc, torch.float32))
        want = prolong_pallas(jqf, jbm, _jcf(xc, jnp.float32))
    else:
        got = prolong(qf, bm, _tcf(xc, torch.float32), _tcf(x, torch.float32), damping)
        want = prolong_pallas(jqf, jbm, _jcf(xc, jnp.float32), r=_jcf(x, jnp.float32),
                              damping=damping)
    _close(cplx.to_numpy(got), jcplx.to_numpy(want), 1e-5)
