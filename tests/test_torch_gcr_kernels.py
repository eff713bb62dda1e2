"""Port parity for kernels K2, K3, K4, B2 and B9: the plain versions of
``gcr_stream_step``, ``ap_update``, ``basis_flush``, ``update_r`` and
``gcr_z_step`` (CPU tensors) against the JAX package's Pallas kernels in
interpret mode, f32, on the main path's operator configuration (two-row
links, anti-periodic t). Fields and reductions: rtol 1e-5 of each
output's scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.pallas import gcr_kernels as jgk
from mgpgcr_tpu.ops.pallas.dslash import compress_links_tmajor, links_to_tmajor
from mgpgcr_tpu.ops.pallas.gcr_dslash import gcr_stream_step as j_gcr_stream_step
from mgpgcr_tpu.ops.pallas.gcr_dslash import gcr_z_step as j_gcr_z_step
from mgpgcr_tpu.ops.wilson_tpu import links_to_tpu
from mgpgcr_tpu_torch import LatticeMesh, cplx, links_from_numpy
from mgpgcr_tpu_torch.kernels.gcr_dslash import gcr_stream_step, gcr_z_step
from mgpgcr_tpu_torch.kernels.gcr_kernels import ap_update, basis_flush, update_r
from mgpgcr_tpu_torch.ops import wilson

DIMS = (4, 4, 4, 4)
SHAPE = (4, 3, 4, 4, 16)
K = 0.125
ALPHA = 0.3 - 0.2j
S_STEP = 2  # each K2 lim is one interpret-mode compile of several seconds
S = 5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _jcf(z):
    return jcplx.CF(jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))


def _tcf(z):
    return cplx.from_numpy(z, torch.float32, "cpu")


def _jscalars(v):
    return jcplx.to_numpy(v)


@pytest.fixture(scope="module")
def data():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = wilson.random_links_np(31, mesh)
    rng = np.random.default_rng(32)

    def field(lead=()):
        sh = lead + SHAPE
        return (rng.standard_normal(sh) + 1j * rng.standard_normal(sh)).astype(np.complex64)

    return {
        "mesh": mesh,
        "links": links,
        "r": field(),
        "az": field(),
        "z": field(),
        "aps": field((S,)),
        "betas": (rng.standard_normal(S) + 1j * rng.standard_normal(S)).astype(np.complex64),
        "w": (rng.standard_normal((2, S + 1)) + 1j * rng.standard_normal((2, S + 1))).astype(
            np.complex64
        ),
    }


@pytest.mark.parametrize("lim", range(1, S_STEP + 1))
def test_gcr_stream_step_matches_jax(data, lim):
    mesh = data["mesh"]
    jmesh = JMesh(mesh.dims)
    links = data["links"]
    jl = compress_links_tmajor(links_to_tmajor(links_to_tpu(_jcf(links), jmesh)))
    aps = data["aps"][:S_STEP]
    want = j_gcr_stream_step(
        jl, _jcf(data["r"]), _jcf(aps), jcplx.from_scalar(ALPHA, jnp.float32),
        jcplx.from_scalar(K, jnp.float32), lim, jmesh, anti_t=True,
    )
    tl = links_from_numpy(links, mesh, "cpu", compress=True)
    got = gcr_stream_step(
        tl, _tcf(data["r"]), _tcf(aps), torch.tensor(ALPHA, dtype=torch.complex64),
        torch.tensor(K, dtype=torch.complex64), lim, mesh, anti_t=True,
    )
    _close(cplx.to_numpy(got[0]), jcplx.to_numpy(want[0]))  # r'
    _close(cplx.to_numpy(got[1]), jcplx.to_numpy(want[1]))  # az
    _close(float(got[2]), float(want[2]))  # ||r'||^2
    _close(got[3].numpy(), _jscalars(want[3]))  # raw, zeros from lim on
    # apr rows [0:lim] and S (the JAX kernel leaves rows lim..S-1 unset)
    rows = list(range(lim)) + [S_STEP]
    _close(got[4].numpy()[rows], _jscalars(want[4])[rows])
    assert np.all(got[4].numpy()[lim:S_STEP] == 0)


@pytest.mark.parametrize("lim", range(1, S + 1))
def test_ap_update_matches_jax(data, lim):
    slot = lim % S  # the solve's slot: j + 1, wrapping to 0 at the cycle end
    aps_j, apn_j = jgk.ap_update(
        _jcf(data["az"]), None, _jcf(data["aps"]), _jcf(data["betas"]), slot, lim
    )
    aps_t = _tcf(data["aps"])
    out, apn = ap_update(_tcf(data["az"]), aps_t, torch.as_tensor(data["betas"]), slot, lim)
    assert out is aps_t  # written in place
    _close(cplx.to_numpy(out), jcplx.to_numpy(aps_j))
    _close(float(apn), float(apn_j))


@pytest.mark.parametrize("nb", range(2, S + 2))
def test_basis_flush_matches_jax(data, nb):
    basis = [data["aps"][m] for m in range(min(nb, S))] + [data["r"]] * (nb - S)
    wx, wp = data["w"][0, :nb], data["w"][1, :nb]
    jx, jp = jgk.basis_flush(
        _jcf(data["az"]), [_jcf(b) for b in basis],
        [jcplx.from_scalar(complex(v), jnp.float32) for v in wx],
        [jcplx.from_scalar(complex(v), jnp.float32) for v in wp],
    )
    tx, tp = basis_flush(
        _tcf(data["az"]), [_tcf(b) for b in basis], torch.as_tensor(wx), torch.as_tensor(wp)
    )
    _close(cplx.to_numpy(tx), jcplx.to_numpy(jx))
    _close(cplx.to_numpy(tp), jcplx.to_numpy(jp))


@pytest.mark.parametrize("lim", range(1, S_STEP + 1))
def test_gcr_z_step_matches_jax(data, lim):
    mesh = data["mesh"]
    jmesh = JMesh(mesh.dims)
    links = data["links"]
    jl = compress_links_tmajor(links_to_tmajor(links_to_tpu(_jcf(links), jmesh)))
    aps = data["aps"][:S_STEP]
    want = j_gcr_z_step(
        jl, _jcf(data["z"]), _jcf(data["r"]), _jcf(aps), jcplx.from_scalar(K, jnp.float32),
        lim, jmesh, anti_t=True,
    )
    tl = links_from_numpy(links, mesh, "cpu", compress=True)
    got = gcr_z_step(
        tl, _tcf(data["z"]), _tcf(data["r"]), _tcf(aps), torch.tensor(K, dtype=torch.complex64),
        lim, mesh, anti_t=True,
    )
    _close(cplx.to_numpy(got[0]), jcplx.to_numpy(want[0]))  # az
    _close(got[1].numpy(), _jscalars(want[1]))  # raw, zeros from lim on
    rows = list(range(lim)) + [S_STEP]
    _close(got[2].numpy()[rows], _jscalars(want[2])[rows])
    assert np.all(got[2].numpy()[lim:S_STEP] == 0)


def test_update_r_matches_jax(data):
    slot = 2
    rp_j, r2_j = jgk.update_r(
        _jcf(data["r"]), _jcf(data["aps"]), slot, jcplx.from_scalar(ALPHA, jnp.float32)
    )
    rp, r2 = update_r(
        _tcf(data["r"]), _tcf(data["aps"]), slot, torch.tensor(ALPHA, dtype=torch.complex64)
    )
    _close(cplx.to_numpy(rp), jcplx.to_numpy(rp_j))
    _close(float(r2), float(r2_j))
