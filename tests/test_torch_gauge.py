"""Port parity for the heat-bath generator (``mgpgcr_tpu_torch/gauge.py``)
against the JAX package's ``gauge.py`` (complex) and ``gauge_tpu.py``
(split re/im, colour-major), on Haar-random links made with numpy from a
seed, (4, 4, 2, 4) lattice as tests/test_gauge_tpu.py.

- ``staples``, ``plaquette`` and ``reunitarize`` against both JAX forms,
  complex128, to 1e-12;
- the port's Kennedy--Pendleton sampler: the mean of h0 at three values of
  alpha within 5 standard errors of the mean of the density
  sqrt(1 - h0^2) exp(2 alpha h0), integrated numerically; its SU(2)
  completion is unitary with det 1;
- sweeps keep the links SU(3) (complex128 to 1e-10, complex64 to 2e-6);
  the first sweep from a cold start leaves the plaquette in (0.5, 1] (as
  tests/test_gauge_tpu.py); ``thermalized_links_cf`` gives canonical split
  links that ``CudaWilsonDirac.build`` takes; the entry points default to
  CUDA. The whole sweep against ``mgpgcr_tpu.gauge.sweep`` with JAX's
  draws replayed: test_torch_gauge_sweep.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu import gauge as jgauge
from mgpgcr_tpu import gauge_tpu as jgauge_tpu
from mgpgcr_tpu_torch import CudaWilsonDirac, LatticeMesh, gauge, thermalized_links
from mgpgcr_tpu_torch import thermalized_links_cf
from mgpgcr_tpu_torch.ops.wilson import random_links_np

DIMS = (4, 4, 2, 4, 4, 3)
PLAQ_B6 = 0.5937


@pytest.fixture(scope="module")
def hot():
    mesh = LatticeMesh(DIMS)
    return mesh, random_links_np(3, mesh)


def _cf_colour_major(z):
    return jgauge_tpu.to_colour_major(jcplx.CF(jnp.asarray(z.real), jnp.asarray(z.imag)))


def test_staples_plaquette_match_jax(hot):
    _, links = hot
    lt = torch.as_tensor(links)
    cf = _cf_colour_major(links)
    for mu in range(4):
        got = gauge.staples(lt, mu).numpy()
        np.testing.assert_allclose(got, np.asarray(jgauge.staples(jnp.asarray(links), mu)),
                                   rtol=0, atol=1e-12)
        a_cf = jcplx.to_numpy(jgauge_tpu.from_colour_major(
            jcplx.stack([jgauge_tpu.staples_cf(cf, mu)] * 4, 0)))[mu]
        np.testing.assert_allclose(got, a_cf, rtol=0, atol=1e-12)
    p = gauge.plaquette(lt)
    assert abs(p - float(jgauge.plaquette(jnp.asarray(links)))) < 1e-12
    assert abs(p - float(jgauge_tpu.plaquette_cf(cf))) < 1e-12
    eye = torch.eye(3, dtype=torch.complex128).expand(4, *DIMS[:4], 3, 3)
    assert abs(gauge.plaquette(eye) - 1.0) < 1e-12


def test_reunitarize_matches_jax(hot):
    _, links = hot
    rng = np.random.default_rng(4)
    drift = links + 1e-3 * (rng.standard_normal(links.shape)
                            + 1j * rng.standard_normal(links.shape))
    got = gauge.reunitarize(torch.as_tensor(drift)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgauge.reunitarize(jnp.asarray(drift))),
                               rtol=0, atol=1e-12)
    cf = jgauge_tpu.from_colour_major(jgauge_tpu.reunitarize_cf(_cf_colour_major(drift)))
    np.testing.assert_allclose(got, jcplx.to_numpy(cf), rtol=0, atol=1e-12)
    uni, det = gauge.unitarity_error(torch.as_tensor(got))
    assert uni < 1e-13 and det < 1e-13


@pytest.mark.parametrize("alpha", [0.5, 2.0, 6.0])
def test_kp_sampler_distribution(alpha):
    n = 200_000
    gen = torch.Generator().manual_seed(int(alpha * 10))
    h0, ok = gauge.kp_sample(gen, torch.full((n,), alpha, dtype=torch.float64))
    assert bool(ok.all()) and float(h0.abs().max()) <= 1.0
    grid = np.linspace(-1.0, 1.0, 200_001)
    w = np.sqrt(1.0 - grid**2) * np.exp(2 * alpha * (grid - 1.0))
    mean = np.trapezoid(grid * w, grid) / np.trapezoid(w, grid)
    sd = float(h0.std())
    assert abs(float(h0.mean()) - mean) < 5 * sd / np.sqrt(n), (float(h0.mean()), mean)
    g = gauge.random_su2_from_h0(gen, h0[:1000], torch.complex128)
    eye = torch.eye(2, dtype=torch.complex128)
    assert float((g @ g.conj().transpose(-1, -2) - eye).abs().max()) < 1e-12
    assert float((torch.linalg.det(g) - 1).abs().max()) < 1e-12


@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-10), (torch.complex64, 2e-6)])
def test_sweeps_stay_su3(hot, dtype, tol):
    mesh, _ = hot
    links, hist = thermalized_links(0, mesh, n_sweeps=3, n_or=1, dtype=dtype,
                                    measure_every=1, device="cpu")
    assert links.shape == (4, *mesh.spacetime_dims, 3, 3) and links.dtype == dtype
    uni, det = gauge.unitarity_error(links)
    assert uni < tol and det < tol
    assert len(hist) == 3 and hist[-1] > 0.35  # ordered from the hot start


def test_cold_start_first_sweep():
    mesh = LatticeMesh(DIMS)
    links, hist = thermalized_links_cf(1, mesh, n_sweeps=2, n_or=1, start="cold",
                                       measure_every=1, device="cpu")
    assert 0.5 < hist[0] <= 1.0 and abs(hist[1] - PLAQ_B6) < 0.3
    assert links.re.dtype == torch.float32 and links.shape == (4, *mesh.spacetime_dims, 3, 3)
    d = CudaWilsonDirac.build(links, mesh, compress=True, device="cpu")
    assert d.links.shape == (4, 4, 2, 3, 4, 2 * 4)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thermalized_links(0, LatticeMesh(DIMS), n_sweeps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thermalized_links_cf(0, LatticeMesh(DIMS), n_sweeps=1)
