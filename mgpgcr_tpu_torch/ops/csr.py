"""CSR sparse matrix: the ingestion and interchange format.

Counterpart of ``mgpgcr_tpu/ops/csr.py`` (the reference's ``Sparse<T>``,
Operator.h:57-552): construction from dense (Operator.h:194-227) and from
sorted triplets with duplicates merged (Operator.h:251-294), SpMV
(Operator.h:331-346), element lookup (391-397), add and subtract
(405-534, without the reference's negated-column quirk Q4), scalar scale
(538-544) and conjugate transpose (297-328). ``CSRMatrix`` stays a host
(numpy) container, as in the JAX package; ``spmv_torch`` is the device
SpMV by ``index_add_`` (the JAX package's ``spmv_jax`` segment sum), and
``to_ell`` the bridge to the device format.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mgpgcr_tpu_torch.ops.ell import ELLOperator


@dataclass(frozen=True)
class CSRMatrix:
    indptr: np.ndarray  # (n_rows + 1,) int64
    indices: np.ndarray  # (nnz,) int
    data: np.ndarray  # (nnz,) complex
    shape: tuple[int, int]

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "CSRMatrix":
        """Dense -> CSR (Operator.h:194-227)."""
        a = np.asarray(a)
        mask = np.abs(a) > tol
        indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
        np.cumsum(mask.sum(axis=1), out=indptr[1:])
        rows, cols = np.nonzero(mask)
        return CSRMatrix(indptr, cols.astype(np.int64), a[rows, cols], a.shape)

    @staticmethod
    def from_triplets(rows, cols, vals, shape: tuple[int, int],
                      sum_duplicates: bool = True) -> "CSRMatrix":
        """Triplets -> CSR, sorted, duplicates summed (Operator.h:251-294)."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows):
            new = np.empty(len(rows), dtype=bool)
            new[0] = True
            new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            group = np.cumsum(new) - 1
            merged = np.zeros(group[-1] + 1, dtype=vals.dtype)
            np.add.at(merged, group, vals)
            rows, cols, vals = rows[new], cols[new], merged
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRMatrix(indptr, cols, vals, shape)

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def dim(self) -> int:
        return self.shape[0]

    def _row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))

    def val_at(self, row: int, col: int):
        """Element lookup (Operator.h:391-397)."""
        lo, hi = self.indptr[row], self.indptr[row + 1]
        seg = self.indices[lo:hi]
        hit = np.searchsorted(seg, col)
        if hit < len(seg) and seg[hit] == col:
            return self.data[lo + hit]
        return self.data.dtype.type(0)

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host SpMV (Operator.h:331-346), the complex128 oracle."""
        out = np.zeros(self.shape[0], dtype=np.result_type(self.data, x))
        np.add.at(out, self._row_ids(), self.data * x[self.indices])
        return out

    def spmv_torch(self, x: torch.Tensor) -> torch.Tensor:
        """Device SpMV of a complex tensor x (n_cols,) on x's device: the
        products gathered by column and summed per row with ``index_add_``."""
        dev = x.device
        rows = torch.as_tensor(self._row_ids()).to(dev)
        cols = torch.as_tensor(np.asarray(self.indices, dtype=np.int64)).to(dev)
        data = torch.as_tensor(self.data).to(dev, x.dtype)
        out = torch.zeros(self.shape[0], dtype=x.dtype, device=dev)
        return out.index_add_(0, rows, data * x[cols])

    def __add__(self, other: "CSRMatrix") -> "CSRMatrix":
        return self._merge(other, +1)

    def __sub__(self, other: "CSRMatrix") -> "CSRMatrix":
        return self._merge(other, -1)

    def _merge(self, other: "CSRMatrix", sign: int) -> "CSRMatrix":
        """Sparse add / subtract (Operator.h:405-534, quirk Q4 fixed)."""
        if self.shape != other.shape:
            raise ValueError(f"shapes {self.shape} and {other.shape} differ")
        rows = np.concatenate([self._row_ids(), other._row_ids()])
        cols = np.concatenate([self.indices, other.indices])
        vals = np.concatenate([self.data, sign * other.data])
        return CSRMatrix.from_triplets(rows, cols, vals, self.shape)

    def scale(self, s) -> "CSRMatrix":
        """Scalar multiply (Operator.h:538-544)."""
        return CSRMatrix(self.indptr, self.indices, self.data * s, self.shape)

    def matmul(self, other: "CSRMatrix") -> "CSRMatrix":
        """SpGEMM, CSR @ CSR, on the host through scipy."""
        import scipy.sparse as sp

        if self.shape[1] != other.shape[0]:
            raise ValueError(f"shapes {self.shape} and {other.shape} do not chain")
        a = sp.csr_matrix((self.data, self.indices, self.indptr), self.shape)
        b = sp.csr_matrix((other.data, other.indices, other.indptr), other.shape)
        c = (a @ b).tocsr()
        c.sort_indices()
        return CSRMatrix(c.indptr.astype(np.int64), c.indices.astype(np.int64), c.data,
                         (self.shape[0], other.shape[1]))

    def dagger(self) -> "CSRMatrix":
        """Conjugate transpose (Operator.h:297-328)."""
        return CSRMatrix.from_triplets(self.indices, self._row_ids(), np.conj(self.data),
                                       (self.shape[1], self.shape[0]), sum_duplicates=False)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        out[self._row_ids(), self.indices] = self.data
        return out

    def to_ell(self, dtype=None, cf: bool = False, device=None) -> ELLOperator:
        """The padded ELL form on ``device`` (CUDA unless named)."""
        return ELLOperator.from_csr(self.indptr, self.indices, self.data, self.shape[1],
                                    dtype=dtype, cf=cf, device=device)
