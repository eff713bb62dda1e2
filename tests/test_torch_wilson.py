"""Port parity for the Wilson--Dirac operator and its state converters.

The port's plain Dslash (``SlabWilsonDirac``, and ``CudaWilsonDirac`` on
CPU tensors) against the JAX package's numpy oracle ``dirac_apply_np``
and its ``TpuWilsonDirac``, periodic and anti-periodic in t, in float64
at 1e-12; gamma5-hermiticity; ``links_from_numpy`` against the JAX
converters; and the port's import and device rules."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.pallas.dslash import compress_links_tmajor, links_to_tmajor
from mgpgcr_tpu.ops.wilson import antiperiodic_t as j_antiperiodic_t
from mgpgcr_tpu.ops.wilson import dirac_apply_np as j_dirac_apply_np
from mgpgcr_tpu.ops.wilson import random_links_np as j_random_links_np
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac, field_to_tpu, links_to_tpu
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    LatticeMesh,
    MGParams,
    SlabWilsonDirac,
    cplx,
    field_from_numpy,
    field_from_slab,
    field_to_numpy,
    field_to_slab,
    fields,
    links_from_numpy,
    mg_from_numpy,
)
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.ops.dslash import links_from_tmajor
from mgpgcr_tpu_torch.ops.wilson_slab import gamma5_slab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATTICES = [(4, 4, 4, 4), (4, 4, 4, 8)]


def _problem(dims, seed=7):
    mesh = LatticeMesh((*dims, 4, 3))
    links = wilson.random_links_np(seed, mesh)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(mesh.size) + 1j * rng.standard_normal(mesh.size)
    return mesh, links, x


def _to_slab64(x, mesh):
    return cplx.from_numpy(field_to_slab(torch.as_tensor(x), mesh).numpy(), torch.float64, "cpu")


def _from_slab(y, mesh):
    return field_from_slab(torch.as_tensor(cplx.to_numpy(y)), mesh).numpy()


def test_oracle_and_links_match_jax():
    mesh, links, x = _problem((4, 4, 4, 8))
    jmesh = JMesh(mesh.dims)
    assert np.array_equal(links, j_random_links_np(7, jmesh))
    np.testing.assert_allclose(
        wilson.dirac_apply_np(links, mesh, x, 0.13 + 0.01j),
        j_dirac_apply_np(links, jmesh, x, 0.13 + 0.01j),
        rtol=0,
        atol=1e-13,
    )
    assert np.array_equal(wilson.antiperiodic_t(links), j_antiperiodic_t(links))
    assert np.array_equal(wilson.unit_links(mesh)[2, 1, 2, 3, 0], np.eye(3))


@pytest.mark.parametrize("anti", [False, True], ids=["periodic", "anti_t"])
@pytest.mark.parametrize("dims", LATTICES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("form", ["slab", "cuda_op"])
def test_plain_dslash_matches_oracle(dims, anti, form):
    mesh, links, x = _problem(dims)
    ref_links = j_antiperiodic_t(links) if anti else links
    ref = j_dirac_apply_np(ref_links, JMesh(mesh.dims), x, 0.0)
    if form == "slab":
        lk = cplx.from_numpy(wilson.antiperiodic_t(links) if anti else links, torch.float64, "cpu")
        d = SlabWilsonDirac.build(lk, mesh)
    else:
        d = CudaWilsonDirac.build(
            links, mesh, antiperiodic_t=anti, link_dtype=torch.float64, device="cpu"
        )
    got = _from_slab(d.apply(_to_slab64(x, mesh)), mesh)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("anti", [False, True], ids=["periodic", "anti_t"])
@pytest.mark.parametrize("dims", LATTICES, ids=lambda d: "x".join(map(str, d)))
def test_plain_dslash_matches_tpu_slab(dims, anti):
    mesh, links, x = _problem(dims, seed=3)
    jl = j_antiperiodic_t(links) if anti else links
    jmesh = JMesh(mesh.dims)
    jd = TpuWilsonDirac.build(jcplx.CF(jnp.asarray(jl.real), jnp.asarray(jl.imag)), jmesh)
    jx = field_to_tpu(jcplx.CF(jnp.asarray(x.real), jnp.asarray(x.imag)), jmesh)
    want = jcplx.to_numpy(jd.apply(jx))
    d = CudaWilsonDirac.build(
        links, mesh, compress=True, antiperiodic_t=anti, link_dtype=torch.float64, device="cpu"
    )
    got = cplx.to_numpy(d.apply(_to_slab64(x, mesh)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("anti", [False, True], ids=["periodic", "anti_t"])
def test_gamma5_hermiticity(anti):
    """gamma5 D gamma5 = D^dagger: <x, g5 D g5 y> = <D x, y>."""
    mesh, links, x = _problem((4, 4, 4, 4), seed=11)
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=anti, link_dtype=torch.float64,
                              device="cpu")
    gen = torch.Generator().manual_seed(5)
    a = cplx.random(gen, d.field_shape, torch.float64, "cpu")
    b = cplx.random(gen, d.field_shape, torch.float64, "cpu")
    lhs = fields.dot(a, gamma5_slab(d.apply(gamma5_slab(b))))
    rhs = fields.dot(d.apply(a), b)
    assert abs(complex(lhs - rhs)) < 1e-12 * abs(complex(rhs))


@pytest.mark.parametrize("compress", [False, True], ids=["3row", "2row"])
def test_links_from_numpy_matches_jax_layout(compress):
    mesh, links, _ = _problem((4, 4, 4, 8))
    jmesh = JMesh(mesh.dims)
    jl = links_to_tmajor(links_to_tpu(jcplx.CF(jnp.asarray(links.real), jnp.asarray(links.imag)),
                                      jmesh))
    if compress:
        jl = compress_links_tmajor(jl)
    for given in (links, (links.real, links.imag)):
        got = links_from_numpy(given, mesh, "cpu", compress=compress, link_dtype=torch.float64)
        assert got.shape == jl.shape
        assert np.array_equal(cplx.to_numpy(got), jcplx.to_numpy(jl))
    if not compress:
        mu_major = links_from_tmajor(got)
        assert np.array_equal(
            cplx.to_numpy(mu_major),
            jcplx.to_numpy(links_to_tpu(jcplx.CF(jnp.asarray(links.real),
                                                 jnp.asarray(links.imag)), jmesh)),
        )


def test_compression_refuses_flipped_links():
    mesh, links, _ = _problem((4, 4, 4, 4))
    with pytest.raises(ValueError, match="SU\\(3\\)"):
        links_from_numpy(wilson.antiperiodic_t(links), mesh, "cpu", compress=True)


def test_field_converters_round_trip():
    mesh, _, x = _problem((4, 4, 4, 8))
    slab = field_to_slab(torch.as_tensor(x), mesh).numpy()
    jslab = np.asarray(field_to_tpu(jnp.asarray(x), JMesh(mesh.dims)))
    assert np.array_equal(slab, jslab)
    f = field_from_numpy(slab, torch.float64, "cpu")
    assert f.shape == (4, 3, 4, 4, 32)
    assert np.array_equal(field_to_numpy(f), slab)


def test_port_imports_no_jax():
    code = (
        "import sys, mgpgcr_tpu_torch, mgpgcr_tpu_torch.kernels, "
        "mgpgcr_tpu_torch.kernels.transfer, mgpgcr_tpu_torch.kernels.gcr_kernels, "
        "mgpgcr_tpu_torch.solvers.gcr, mgpgcr_tpu_torch.solvers.mg, "
        "mgpgcr_tpu_torch.solvers.power, mgpgcr_tpu_torch.ops.dense; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'mgpgcr_tpu' or m.startswith('mgpgcr_tpu.')]; "
        "assert not bad, bad"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


ENTRY_POINTS = {
    "links_from_numpy": lambda m, lk: links_from_numpy(lk, m),
    "build": lambda m, lk: CudaWilsonDirac.build(lk, m),
    "field_from_numpy": lambda m, lk: field_from_numpy(np.zeros((4, 3, 4, 4, 16), complex)),
    "cplx_random": lambda m, lk: cplx.random(torch.Generator(), (4,)),
    "random_field": lambda m, lk: fields.random_field(torch.Generator(), m),
    "mg_from_numpy": lambda m, lk: mg_from_numpy(
        None, m, np.zeros((2, 4, 3, 4, 4, 16), complex), np.zeros((32, 32), complex),
        MGParams(block=2, n_nullvecs=1),
    ),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name):
    """Without ``device=``, an entry point targets CUDA; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mesh, links, _ = _problem((4, 4, 4, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](mesh, links)
