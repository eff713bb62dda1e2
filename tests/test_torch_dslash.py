"""Port parity for kernel K1: the plain version of the Dslash kernel
(``kernels/dslash.py::dslash_apply`` on CPU tensors) against the JAX
package's ``dslash_apply`` streaming kernel in Pallas interpret mode, on
t-major links with 3 or 2 rows, f32 or bf16 storage, with and without the
fused k and the anti-periodic t sign. f32 fields: rtol 1e-5 of the
output's scale. The JAX side gets the same bf16-rounded links."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.pallas.dslash import (
    compress_links_tmajor,
    dslash_apply as j_dslash_apply,
    links_to_tmajor,
)
from mgpgcr_tpu.ops.wilson_tpu import links_to_tpu
from mgpgcr_tpu_torch import LatticeMesh, cplx, links_from_numpy
from mgpgcr_tpu_torch.kernels.dslash import dslash_apply
from mgpgcr_tpu_torch.ops import wilson

DIMS = (4, 4, 4, 4)
K = 0.12 + 0.03j


@pytest.fixture(scope="module")
def problem():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = wilson.random_links_np(21, mesh)
    rng = np.random.default_rng(22)
    shape = (4, 3, DIMS[0], DIMS[1], DIMS[2] * DIMS[3])
    psi = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return mesh, links, psi


# (rows, link dtype, fused k, anti_t): each JAX case is one interpret-mode
# compile of several seconds, so two cases take every option both ways;
# the first is the main path's configuration
CASES = [
    (2, "f32", True, True),
    (3, "bf16", False, False),
]


@pytest.mark.parametrize("rows,ldt,fuse,anti", CASES,
                         ids=lambda v: str(v))
def test_plain_k1_matches_jax_kernel(problem, rows, ldt, fuse, anti):
    mesh, links, psi = problem
    jmesh = JMesh(mesh.dims)
    jl = links_to_tmajor(
        links_to_tpu(
            jcplx.CF(jnp.asarray(links.real, jnp.float32), jnp.asarray(links.imag, jnp.float32)),
            jmesh,
        )
    )
    if rows == 2:
        jl = compress_links_tmajor(jl)
    if ldt == "bf16":
        jl = jl.astype(jnp.bfloat16)
    jpsi = jcplx.CF(jnp.asarray(psi.real, jnp.float32), jnp.asarray(psi.imag, jnp.float32))
    jk = jcplx.from_scalar(K, jnp.float32) if fuse else None
    want = jcplx.to_numpy(
        j_dslash_apply(jl, jpsi, jmesh, interpret=True, k=jk, anti_t=anti)
    )

    tl = links_from_numpy(
        links, mesh, "cpu", compress=rows == 2,
        link_dtype=torch.bfloat16 if ldt == "bf16" else torch.float32,
    )
    assert np.array_equal(cplx.to_numpy(tl), jcplx.to_numpy(jl))
    tk = torch.tensor(K, dtype=torch.complex64) if fuse else None
    got = cplx.to_numpy(
        dslash_apply(tl, cplx.from_numpy(psi, torch.float32, "cpu"), mesh, tk, anti)
    )
    assert dslash_apply.launches == 0  # CPU tensors never launch the kernel
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
