"""The frozen yardstick on the CPU: the float64 Wilson--Dirac reference
against the free field's plane waves, its residual under a gauge
transform, its agreement with the program's own operator, and the byte
models against the counts of the port's kernel table."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import sources
from portbench.reference import roofline, wilson

DIMS = (4, 4, 4, 4)


def _haar_links(seed):
    gen = torch.Generator().manual_seed(seed)
    return sources.haar_su3(gen, (4, *DIMS), "cpu")


@pytest.mark.parametrize("antiperiodic", [False, True])
@pytest.mark.parametrize("n", [(0, 0, 0, 0), (1, 2, 0, 3), (3, 1, 1, 2)])
def test_free_field_plane_waves(antiperiodic, n):
    """U = 1: D e^{ipx} chi = (2 sum cos p - 2i sum gamma sin p) e^{ipx} chi,
    p_t shifted by pi/T under the anti-periodic boundary; chi an
    eigenvector of sum gamma sin p gives the eigenvalue directly."""
    k = 0.13
    p = [2 * math.pi * n[mu] / DIMS[mu] for mu in range(4)]
    if antiperiodic:
        p[0] += math.pi / DIMS[0]
    g = wilson.gammas()
    m = sum(math.sin(p[mu]) * g[mu] for mu in range(4))
    evals, evecs = torch.linalg.eigh(m)
    coords = torch.stack(torch.meshgrid(*[torch.arange(d) for d in DIMS], indexing="ij"), -1)
    phase = torch.exp(1j * (coords.double() @ torch.tensor(p, dtype=torch.float64)))
    links = torch.eye(3, dtype=torch.complex128).expand(4, *DIMS, 3, 3)
    colour = torch.tensor([0.3, -0.5j, 0.8], dtype=torch.complex128)
    for j in range(4):
        chi = evecs[:, j]
        psi = phase[..., None, None] * chi[:, None] * colour
        lam = 1 - k * (2 * sum(math.cos(q) for q in p) - 2j * float(evals[j]))
        got = wilson.dirac(links, psi, k, antiperiodic)
        assert torch.allclose(got, lam * psi, atol=1e-12)


def test_residual_gauge_invariant():
    links = _haar_links(1)
    gen = torch.Generator().manual_seed(2)
    g = sources.haar_su3(gen, DIMS, "cpu")
    moved = torch.stack([g @ links[mu] @ torch.roll(g, -1, mu).conj().transpose(-1, -2)
                         for mu in range(4)])
    b = torch.randn(*DIMS, 4, 3, dtype=torch.complex128, generator=gen)
    x = torch.randn(*DIMS, 4, 3, dtype=torch.complex128, generator=gen)
    rel = wilson.relative_residual(links, 0.14, b, x)

    def gt(v):
        return torch.einsum("tzyxab,tzyxsb->tzyxsa", g, v)

    assert wilson.relative_residual(moved, 0.14, gt(b), gt(x)) == pytest.approx(rel, rel=1e-12)
    # and the operator itself is covariant
    lhs = wilson.dirac(moved, gt(x), 0.14)
    assert torch.allclose(lhs, gt(wilson.dirac(links, x, 0.14)), atol=1e-12)


def test_gauge_transform_helper_is_covariant():
    links = _haar_links(3)
    pair = (links.real.float(), links.imag.float())
    moved = sources.gauge_transform(pair, torch.Generator().manual_seed(4))
    u = torch.complex(moved[0].double(), moved[1].double())
    eye = torch.eye(3, dtype=torch.complex128)
    assert torch.allclose(u @ u.conj().transpose(-1, -2), eye.expand_as(u), atol=1e-6)
    # the plaquette trace is gauge invariant
    def plaq(v):
        return (v[0] @ torch.roll(v[1], -1, 0) @ v[0].roll(-1, 1).conj().transpose(-1, -2)
                @ v[1].conj().transpose(-1, -2)).diagonal(dim1=-2, dim2=-1).sum(-1)

    assert torch.allclose(plaq(u), plaq(links), atol=1e-5)


@pytest.mark.parametrize("antiperiodic", [False, True])
def test_reference_matches_the_programs_operator(antiperiodic):
    """The same operator as the program's plain version on the CPU, and as
    its numpy oracle: the yardstick measures the program's mathematics."""
    from mgpgcr_tpu_torch import CudaWilsonDirac, DiracOperator, LatticeMesh, cplx
    from mgpgcr_tpu_torch.ops.wilson import antiperiodic_t, dirac_apply_np

    mesh = LatticeMesh((*DIMS, 4, 3))
    links = _haar_links(5)
    gen = torch.Generator().manual_seed(6)
    b = sources.noise_source(gen, DIMS, "cpu")
    x_lat = sources.slab_to_lattice(*b, DIMS)
    ref = wilson.dirac(links, x_lat, 0.14, antiperiodic)
    lk = links.numpy()
    oracle = dirac_apply_np(antiperiodic_t(lk) if antiperiodic else lk, mesh,
                            sources.lattice_to_flat(x_lat).numpy(), 0.14)
    assert np.abs(sources.lattice_to_flat(ref).numpy() - oracle).max() < 1e-12
    d = CudaWilsonDirac.build(cplx.CF(links.real, links.imag), mesh, antiperiodic_t=antiperiodic,
                              link_dtype=torch.float64, device="cpu")
    y = DiracOperator(d, 0.14).apply(cplx.CF(b[0].double(), b[1].double()))
    got = sources.slab_to_lattice(y.re, y.im, DIMS)
    assert torch.allclose(got, ref, atol=1e-12)


def test_layout_round_trip_matches_the_programs():
    from mgpgcr_tpu_torch import LatticeMesh
    from mgpgcr_tpu_torch.ops.wilson_slab import field_from_slab

    mesh = LatticeMesh((*DIMS, 4, 3))
    re, im = sources.noise_source(torch.Generator().manual_seed(8), DIMS, "cpu")
    flat = sources.lattice_to_flat(sources.slab_to_lattice(re, im, DIMS))
    theirs = field_from_slab(torch.complex(re.double(), im.double()), mesh)
    assert torch.equal(flat, theirs)


def test_byte_models_match_the_kernel_table():
    """The port's kernel table (PERF.md): K1 402.7 MB, K2 805.3 MB and K3
    503.3 MB (mean over lim 1-5), K4 906.0 MB, B12 119.3 MB (4096 block
    rows, ne 20), one f32 field 100.7 MB at 32^4."""
    dims = (32, 32, 32, 32)
    f = roofline.field_bytes(dims)
    assert round(f / 1e6, 1) == 100.7
    assert round(roofline.dslash_bytes(dims) / 1e6, 1) == 402.7
    assert round(roofline.stencil_apply_bytes(4096, 20) / 1e6, 1) == 119.3
    # the GCR(5) iteration: (3 + mean live 3) fields + links, and 9 fields a cycle
    per_iter = roofline.gcr_iteration_bytes(dims, 5)
    assert per_iter == pytest.approx(6 * f + roofline.link_bytes(dims) + 9 * f / 5)
    assert per_iter < (8 + 5 + 9 / 5) * f  # below the kernels' own K2 + K3 + K4/5
    at_peak = per_iter / roofline.HBM_BYTES_PER_S
    assert roofline.share_percent(per_iter, at_peak) == pytest.approx(100)
    assert roofline.share_percent(1.0, 0.0) is None
