"""MG checkpoints of the port (``mgpgcr_tpu_torch/io/checkpoint.py``) read
and written against the JAX package's ``save_mg_setup`` /
``load_mg_setup``. float64, CPU, 4^4 lattice, k = 0.12, anti-periodic t,
block 2, one near-null vector (ne = 2), the smoother off (the deflation
apply M = I + P C^-1 P^H, its coarse GCR to 1e-10, so M is linear to
round-off). No JAX MG setup runs (its compile would dominate the file):
the port builds the hierarchy, and the JAX side is whatever
``load_mg_setup`` builds from the port's file.

Round trip per case: the port saves (file A); JAX loads it and its
V-cycle apply is held to the port's on the same input (port -> JAX); JAX
saves what it loaded (file B), which holds the same keys, dtypes, shapes,
values and meta as A; the port loads B and its apply is held to JAX's
(JAX -> port). Tolerance: 1e-10 of the output's scale. Cases: the slab
("tpu") layout with the dense, block-ELL and block-stencil coarse
operators and a two-level hierarchy (n_level = 3, stencil), and the flat
layout on the ingested ELL operator. The loaded hierarchy on the port's
side repeats the original's apply bit for bit, and a sharded file is
refused by the single-device loader.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.io.checkpoint import load_mg_setup as j_load_mg_setup
from mgpgcr_tpu.io.checkpoint import save_mg_setup as j_save_mg_setup
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.ell import ELLOperator as JELL
from mgpgcr_tpu.ops.wilson import antiperiodic_t as j_antiperiodic_t
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    cplx,
    load_mg_setup,
    save_mg_setup,
    setup_mg,
)
from mgpgcr_tpu_torch.ops.wilson import materialize_csr, random_links_np

K = 0.12
DIMS = (4, 4, 4, 4)
TOL = 1e-10


def _params(**kw):
    base = dict(block=2, n_nullvecs=1, setup_power_iters=2,
                setup_gcr=GCRParams(tol=1e-6, max_iter=4, restart=4),
                coarse_gcr=GCRParams(tol=1e-10, max_iter=40, restart=10), smoother_gcr=None)
    base.update(kw)
    return MGParams(**base)


@pytest.fixture(scope="module")
def lattice():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = random_links_np(3, mesh)
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, link_dtype=torch.float64,
                              device="cpu")
    a = DiracOperator(d, torch.tensor(K, dtype=torch.complex128))
    jm = JMesh((*DIMS, 4, 3))
    jd = TpuWilsonDirac.build(jcplx.ascf(jnp.asarray(j_antiperiodic_t(links)), jnp.float64), jm)
    ja = JDirac(jd, jcplx.from_scalar(K, jnp.float64))
    rng = np.random.default_rng(5)
    r = rng.standard_normal(d.field_shape) + 1j * rng.standard_normal(d.field_shape)
    return mesh, links, a, ja, r


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _round_trip(tmp_path, mgp, ja, r, port_fine):
    """Port save -> JAX load and apply; JAX save -> port load and apply."""
    fa, fb = tmp_path / "port.npz", tmp_path / "jax.npz"
    save_mg_setup(fa, mgp)
    jmgp = j_load_mg_setup(str(fa), ja)
    want = mgp.apply(cplx.from_numpy(r, torch.float64, "cpu"))
    # jitted: one compile of the V-cycle instead of one per eager operation
    got_jax = jcplx.to_numpy(jax.jit(jmgp.apply)(jcplx.ascf(jnp.asarray(r), jnp.float64)))
    scale = np.abs(cplx.to_numpy(want)).max()
    assert np.abs(got_jax - cplx.to_numpy(want)).max() <= TOL * scale  # port -> JAX

    j_save_mg_setup(str(fb), jmgp)
    a_arr, b_arr = _arrays(fa), _arrays(fb)
    assert sorted(a_arr) == sorted(b_arr)
    for key in a_arr:
        if key == "meta":
            assert json.loads(str(a_arr[key])) == json.loads(str(b_arr[key]))
            continue
        assert a_arr[key].dtype == b_arr[key].dtype and a_arr[key].shape == b_arr[key].shape, key
        np.testing.assert_array_equal(a_arr[key], b_arr[key])

    loaded = load_mg_setup(fb, port_fine)
    got = loaded.apply(cplx.from_numpy(r, torch.float64, "cpu"))
    assert np.abs(cplx.to_numpy(got) - got_jax).max() <= TOL * scale  # JAX -> port
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    return loaded


@pytest.mark.parametrize("fmt,n_level", [("dense", 2), ("bsr", 2), ("stencil", 2),
                                         ("stencil", 3)])
def test_slab_layout_round_trip(lattice, tmp_path, fmt, n_level):
    mesh, _, a, ja, r = lattice
    mgp = setup_mg(torch.Generator().manual_seed(3), a, mesh,
                   _params(coarse_format=fmt, n_level=n_level))
    assert (mgp.coarse_precond is not None) == (n_level == 3)
    loaded = _round_trip(tmp_path, mgp, ja, r, a)
    assert loaded.layout == "tpu" and loaded.q is None
    assert type(loaded.coarse) is type(mgp.coarse)
    assert (loaded.coarse_precond is not None) == (n_level == 3)
    meta = json.loads(str(_arrays(tmp_path / "port.npz")["meta"]))
    assert meta["version"] == 2 and len(meta["levels"]) == n_level - 1
    if fmt == "stencil":
        assert meta["levels"][0]["coarse_backend"] == "xla"
        assert meta["levels"][0]["coarse_dims"] == [2, 2, 2, 2]


def test_flat_layout_round_trip(lattice, tmp_path):
    """The ingested route's flat CF fields: ELL operators on both sides."""
    mesh, links, _, _, _ = lattice
    csr = materialize_csr(j_antiperiodic_t(links), mesh)
    a = DiracOperator(csr.to_ell(dtype=torch.float64, cf=True, device="cpu"), K)
    ell = csr.to_ell(device="cpu")
    jell = JELL(jcplx.ascf(jnp.asarray(ell.vals.numpy()), jnp.float64),
                jnp.asarray(ell.cols.numpy()), ell.n_cols)
    ja = JDirac(jell, jcplx.from_scalar(K, jnp.float64))
    mgp = setup_mg(torch.Generator().manual_seed(3), a, mesh, _params(), layout="flat")
    r = np.random.default_rng(6).standard_normal(mesh.size) \
        + 1j * np.random.default_rng(7).standard_normal(mesh.size)
    loaded = _round_trip(tmp_path, mgp, ja, r, a)
    assert loaded.layout == "flat" and loaded.q_field is None


def test_sharded_file_refused(lattice, tmp_path):
    _, _, a, _, _ = lattice
    np.savez(tmp_path / "s.npz", meta=json.dumps({"version": 2, "sharded": True, "levels": []}))
    with pytest.raises(ValueError, match="sharded"):
        load_mg_setup(tmp_path / "s.npz", a)
    np.savez(tmp_path / "v1.npz", meta=json.dumps({"version": 1, "levels": []}))
    with pytest.raises(ValueError, match="version"):
        load_mg_setup(tmp_path / "v1.npz", a)
