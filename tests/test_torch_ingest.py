"""Port parity for matrix ingestion: the CSR, COO and ELL formats, the
readers and writers of ``io/``, ``materialize_csr`` / ``materialize_ell``,
``StencilBlockOperator.from_csr`` and the Wilson detection of
``ops/ingest.py``, against the JAX package on inputs made with numpy from
a seed (4^4 lattices; f64, to 1e-12 of scale unless named).

- ``CSRMatrix`` (constructors, lookup, algebra, host and torch SpMV),
  ``COOMatrix`` and ``ELLOperator`` (complex and split values) against
  JAX's;
- ``materialize_csr`` equal to JAX's array for array; ``detect_wilson`` on
  it, on a spin-conjugated copy (spatial gammas flipped) and on rejected
  inputs, as JAX's; the routed operator (both backends) against
  ``dirac_apply_np`` and the CSR oracle; ``from_csr`` against JAX's;
- parsed.txt and ``.mtx`` read natively and by numpy, each against the
  other and against JAX's readers; files written by one package read by
  the other; the ELL ``.npz`` written by one package loaded by the other,
  and byte for byte the same file;
- the native library built from ``native/parse.cpp`` into a fresh
  directory loads with ABI 2; the new modules import no JAX; the entry
  points default to CUDA.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu.io import matrix_market as j_mm
from mgpgcr_tpu.io import npz_cache as j_npz
from mgpgcr_tpu.io import parsed_txt as j_txt
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.blockstencil import StencilBlockOperator as JStencil
from mgpgcr_tpu.ops.csr import CSRMatrix as JCSR
from mgpgcr_tpu.ops.ingest import detect_wilson as j_detect_wilson
from mgpgcr_tpu.ops.wilson import materialize_csr as j_materialize_csr
from mgpgcr_tpu_torch import (
    COOMatrix,
    CSRMatrix,
    LatticeMesh,
    StencilBlockOperator,
    cplx,
    detect_wilson,
    materialize_csr,
    materialize_ell,
    wilson_operator_from_csr,
)
from mgpgcr_tpu_torch.io import (
    load_ell_npz,
    matrix_market,
    native_parse,
    parsed_txt,
    read_matrix_market,
    read_parsed_txt,
    save_ell_npz,
    write_parsed_txt,
)
from mgpgcr_tpu_torch.ops.wilson import dirac_apply_np, random_links_np
from mgpgcr_tpu_torch.ops.wilson_slab import field_from_slab, field_to_slab

REPO = Path(__file__).resolve().parent.parent
DIMS = (4, 4, 4, 4)
K = 0.15


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def _rand_dense(seed, n=12):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    a[rng.random((n, n)) < 0.6] = 0.0
    np.fill_diagonal(a, 1.0)
    return a


@pytest.fixture(scope="module")
def wilson():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = random_links_np(11, mesh)
    return mesh, links, materialize_csr(links, mesh)


def _same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(np.asarray(got.indptr), np.asarray(want.indptr))
    np.testing.assert_array_equal(np.asarray(got.indices), np.asarray(want.indices))
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))


def test_csr_matches_jax():
    a, b = _rand_dense(1), _rand_dense(2)
    m, jm = CSRMatrix.from_dense(a), JCSR.from_dense(a)
    m2, jm2 = CSRMatrix.from_dense(b), JCSR.from_dense(b)
    _same_csr(m, jm)
    for got, want in ((m + m2, jm + jm2), (m - m2, jm - jm2), (m.dagger(), jm.dagger()),
                      (m.scale(0.5 - 2j), jm.scale(0.5 - 2j)), (m.matmul(m2), jm.matmul(jm2))):
        _same_csr(got, want)
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 12, 40), rng.integers(0, 12, 40)
    vals = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    _same_csr(CSRMatrix.from_triplets(rows, cols, vals, (12, 12)),
              JCSR.from_triplets(rows, cols, vals, (12, 12)))
    _same_csr(COOMatrix(rows, cols, vals, (12, 12)).to_csr(),
              JCSR.from_triplets(rows, cols, vals, (12, 12)))
    np.testing.assert_array_equal(COOMatrix(rows, cols, vals, (12, 12)).to_dense(),
                                  JCSR.from_triplets(rows, cols, vals, (12, 12)).to_dense())
    assert m.val_at(3, 3) == jm.val_at(3, 3) and m.val_at(0, 5) == jm.val_at(0, 5)
    np.testing.assert_array_equal(m.to_dense(), a)
    x = rng.standard_normal(12) + 1j * rng.standard_normal(12)
    _close(m.spmv(x), a @ x)
    _close(m.spmv_torch(torch.as_tensor(x)).numpy(), np.asarray(jm.spmv_jax(jnp.asarray(x))))


def test_ell_matches_jax():
    a = _rand_dense(4)
    jell = JCSR.from_dense(a).to_ell()
    ell = CSRMatrix.from_dense(a).to_ell(device="cpu")
    np.testing.assert_array_equal(ell.vals.numpy(), np.asarray(jell.vals))
    np.testing.assert_array_equal(ell.cols.numpy(), np.asarray(jell.cols))
    assert ell.shape == jell.shape and ell.nnz == jell.nnz
    np.testing.assert_array_equal(ell.to_dense().numpy(), np.asarray(jell.to_dense()))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 12)) + 1j * rng.standard_normal((3, 12))
    want = np.asarray(jell.apply(jnp.asarray(x)))
    _close(ell.apply(torch.as_tensor(x)).numpy(), want)
    split = CSRMatrix.from_dense(a).to_ell(cf=True, dtype=torch.float64, device="cpu")
    _close(cplx.to_numpy(split.apply(cplx.from_numpy(x, torch.float64, "cpu"))), want)
    _close(ell.scale(2j).apply(torch.as_tensor(x)).numpy(), 2j * want)


def test_materialize_matches_jax(wilson):
    mesh, links, csr = wilson
    _same_csr(csr, j_materialize_csr(links, JMesh(mesh.dims)))
    ell = materialize_ell(links, mesh, device="cpu")
    x = np.random.default_rng(6).standard_normal(mesh.size) + 0j
    _close(ell.apply(torch.as_tensor(x)).numpy(), dirac_apply_np(links, mesh, x))


def _spin_flipped(csr):
    """(S x 1) D (S^-1 x 1) for S = gamma_t = diag(1, 1, -1, -1): the
    spatial gammas flipped, the reference fixture's convention."""
    sign = np.where((np.arange(csr.shape[0]) // 3) % 4 < 2, 1.0, -1.0)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    return CSRMatrix(csr.indptr, csr.indices, csr.data * sign[rows] * sign[csr.indices],
                     csr.shape)


@pytest.mark.parametrize("flip", [False, True])
def test_detect_wilson_matches_jax(wilson, flip):
    mesh, links, csr = wilson
    m = _spin_flipped(csr) if flip else csr
    det = detect_wilson(m, DIMS)
    jdet = j_detect_wilson(JCSR(m.indptr, m.indices, m.data, m.shape), DIMS)
    assert det is not None and jdet is not None
    assert det.signs == jdet.signs == ((1, -1, -1, -1) if flip else (1, 1, 1, 1))
    assert det.diag == jdet.diag == 0
    np.testing.assert_array_equal(det.links, jdet.links)
    assert det.max_error == jdet.max_error and det.max_error < 1e-12
    if flip:
        np.testing.assert_array_equal(det.spin_transform, jdet.spin_transform)
    else:
        assert det.spin_transform is None and jdet.spin_transform is None
    _close(det.links, links, 1e-13)


def test_detect_wilson_rejects(wilson):
    mesh, _, csr = wilson
    data = csr.data.copy()
    data[len(data) // 2] += 1e-3  # breaks the Kronecker structure
    bad = CSRMatrix(csr.indptr, csr.indices, data, csr.shape)
    assert detect_wilson(bad, DIMS) is None
    assert j_detect_wilson(JCSR(bad.indptr, bad.indices, bad.data, bad.shape), DIMS) is None
    assert detect_wilson(csr, (2, 8, 4, 4)) is None  # an extent under 3


@pytest.mark.parametrize("backend", ["cuda", "slab"])
@pytest.mark.parametrize("flip", [False, True])
def test_routed_operator_matches_oracle(wilson, backend, flip):
    mesh, links, csr = wilson
    m = _spin_flipped(csr) if flip else csr
    a = wilson_operator_from_csr(m, DIMS, K, dtype=torch.float64, backend=backend,
                                 device="cpu")
    rng = np.random.default_rng(7)
    x = rng.standard_normal(mesh.size) + 1j * rng.standard_normal(mesh.size)
    want = x - K * m.spmv(x)
    if not flip:
        _close(want, dirac_apply_np(links, mesh, x, K))
    xs = cplx.ascf(field_to_slab(torch.as_tensor(x), mesh)).contiguous()
    y = a.apply(xs)
    got = field_from_slab(torch.complex(y.re, y.im), mesh).numpy()
    _close(got, want)


def test_routed_operator_refuses():
    mesh = LatticeMesh((*DIMS, 4, 3))
    csr = materialize_csr(random_links_np(12, mesh), mesh)
    with pytest.raises(ValueError, match="backend"):
        wilson_operator_from_csr(csr, DIMS, K, backend="pallas", device="cpu")
    shifted = csr + CSRMatrix.from_dense(0.5 * np.eye(mesh.size))
    with pytest.raises(ValueError, match="diagonal"):
        wilson_operator_from_csr(shifted, DIMS, K, device="cpu")
    assert wilson_operator_from_csr(CSRMatrix.from_dense(np.eye(mesh.size)), (2, 4, 4, 4), K,
                                    device="cpu") is None


def test_from_csr_matches_jax(wilson):
    mesh, _, csr = wilson
    op = StencilBlockOperator.from_csr(csr, DIMS, 12, dtype=torch.float64, device="cpu")
    jop = JStencil.from_csr(csr, DIMS, 12)
    _close(cplx.to_numpy(op.blocks), np.asarray(jop.blocks))
    x = np.random.default_rng(8).standard_normal(mesh.size) + 0j
    want = np.asarray(jop.apply(jnp.asarray(x)))
    _close(op.apply(torch.as_tensor(x)).numpy(), want)
    _close(want, csr.spmv(x))
    assert StencilBlockOperator.from_csr(csr, (256,), 12, device="cpu") is None  # t hops


@pytest.fixture(scope="module")
def native_lib():
    if not native_parse.available():
        pytest.skip("no native parser (needs g++)")
    return native_parse


def _jax_numpy_parsers(monkeypatch):
    """Force the JAX package's readers and writers onto numpy."""
    from mgpgcr_tpu.io import native_parse as j_native

    monkeypatch.setattr(j_native, "_LIB", None)
    monkeypatch.setattr(j_native, "_TRIED", True)


def _read_native(p):
    fast = native_parse.read_parsed_txt_native(str(p))
    assert fast is not None
    return CSRMatrix(*fast)


def _write_native(p, m):
    assert native_parse.write_parsed_txt_native(str(p), m.indptr, m.indices, m.data, m.shape)


PARSED_TXT = {"native": (_write_native, _read_native),
              "numpy": (parsed_txt._write_numpy, parsed_txt._read_numpy)}


@pytest.mark.parametrize("way", sorted(PARSED_TXT))
def test_parsed_txt_round_trip(native_lib, tmp_path, monkeypatch, wilson, way):
    _, _, csr = wilson
    write, read = PARSED_TXT[way]
    other = PARSED_TXT["numpy" if way == "native" else "native"][1]
    if way == "numpy":
        _jax_numpy_parsers(monkeypatch)
    p = tmp_path / "parsed.txt"
    write(p, csr)
    got = read(p)
    _same_csr(got, other(p))
    _same_csr(got, read_parsed_txt(p))
    _same_csr(got, j_txt.read_parsed_txt(p))
    np.testing.assert_array_equal(got.indptr, csr.indptr)
    np.testing.assert_array_equal(got.indices, csr.indices)
    np.testing.assert_allclose(got.data, csr.data, rtol=1e-5, atol=1e-6)  # %.6g text
    q = tmp_path / "jax.txt"
    j_txt.write_parsed_txt(q, JCSR(csr.indptr, csr.indices, csr.data, csr.shape))
    _same_csr(read(q), got)
    assert p.read_bytes() == q.read_bytes()


MTX = {
    "general": "%%MatrixMarket matrix coordinate complex general\n% comment\n3 3 4\n"
               "1 1 1.5 -2.5\n2 3 0.25 0.75\n3 1 -1.0 0.0\n3 3 4.0 1.0\n",
    "hermitian": "%%MatrixMarket matrix coordinate complex hermitian\n3 3 3\n"
                 "1 1 2.0 0.0\n2 1 1.5 -0.5\n3 2 -2.0 1.0\n",
    "skew-symmetric": "%%MatrixMarket matrix coordinate real skew-symmetric\n3 3 2\n"
                      "2 1 1.5\n3 2 -2.0\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n1 2\n2 1\n",
}


@pytest.mark.parametrize("kind", sorted(MTX))
def test_matrix_market_matches_jax(native_lib, tmp_path, monkeypatch, kind):
    p = tmp_path / "m.mtx"
    p.write_text(MTX[kind])
    if kind == "pattern":  # the native parser reads value fields only
        _jax_numpy_parsers(monkeypatch)
    want = j_mm.read_matrix_market(p)
    for read in (read_matrix_market, matrix_market._read_numpy):
        got = read(p)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.rows, np.asarray(want.rows))
        np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
        np.testing.assert_array_equal(got.vals, np.asarray(want.vals))


def test_ell_npz_both_ways(tmp_path, wilson):
    mesh, links, csr = wilson
    ell = csr.to_ell(device="cpu")
    jell = JCSR(csr.indptr, csr.indices, csr.data, csr.shape).to_ell()
    ours, theirs = tmp_path / "torch.npz", tmp_path / "jax.npz"
    save_ell_npz(ours, ell)
    j_npz.save_ell_npz(theirs, jell)
    assert ours.read_bytes() == theirs.read_bytes()
    back = j_npz.load_ell_npz(ours)
    np.testing.assert_array_equal(np.asarray(back.vals), ell.vals.numpy())
    np.testing.assert_array_equal(np.asarray(back.cols), ell.cols.numpy())
    assert back.n_cols == ell.n_cols
    got = load_ell_npz(theirs, dtype=torch.complex64, device="cpu")
    assert got.vals.dtype == torch.complex64 and got.n_cols == jell.n_cols
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(jell.vals).astype(np.complex64))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(jell.cols))


def test_native_build_from_source(tmp_path):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    path = native_parse.build(tmp_path)
    assert path.parent == tmp_path and native_parse.load(path) is not None
    assert native_parse.build(tmp_path) == path  # built once per source


def test_new_modules_import_no_jax():
    code = (
        "import sys, mgpgcr_tpu_torch, mgpgcr_tpu_torch.io, mgpgcr_tpu_torch.io.native_parse, "
        "mgpgcr_tpu_torch.ops.csr, mgpgcr_tpu_torch.ops.coo, mgpgcr_tpu_torch.ops.ell, "
        "mgpgcr_tpu_torch.ops.ingest, mgpgcr_tpu_torch.ops.eo, mgpgcr_tpu_torch.solvers.eo, "
        "mgpgcr_tpu_torch.solvers.refine, mgpgcr_tpu_torch.solvers.eigen, "
        "mgpgcr_tpu_torch.gauge; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'mgpgcr_tpu' or m.startswith('mgpgcr_tpu.')]; "
        "assert not bad, bad"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


ENTRY_POINTS = {
    "to_ell": lambda csr, p: csr.to_ell(),
    "materialize_ell": lambda csr, p: materialize_ell(
        random_links_np(1, LatticeMesh((*DIMS, 4, 3))), LatticeMesh((*DIMS, 4, 3))),
    "from_csr": lambda csr, p: StencilBlockOperator.from_csr(csr, DIMS, 12),
    "wilson_operator_from_csr": lambda csr, p: wilson_operator_from_csr(csr, DIMS, K),
    "load_ell_npz": lambda csr, p: load_ell_npz(p),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(wilson, tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, csr = wilson
    p = tmp_path / "e.npz"
    save_ell_npz(p, CSRMatrix.from_dense(np.eye(4)).to_ell(device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](csr, p)
