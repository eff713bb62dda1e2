"""ELLPACK sparse operator: the device format of ingested matrices.

Counterpart of ``mgpgcr_tpu/ops/ell.py``. The Wilson--Dirac matrices this
package ingests have a fixed number of non-zeros per row (39 for the
reference's 4^4 fixture), so ELLPACK is lossless: values and column
indices live in dense ``(n_rows, K)`` tensors, padded with zero values and
row-local column indices. The apply is a gather and a sum over the row
(plain PyTorch, as the JAX form is plain XLA: no kernel of the port).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.ops.base import LinearOperator


@dataclasses.dataclass(frozen=True)
class ELLOperator(LinearOperator):
    vals: object  # (n_rows, K) complex tensor, or a CF of real tensors; zero-padded
    cols: torch.Tensor  # (n_rows, K) int32; padding points at the row's own index
    n_cols: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.vals.shape[0], self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def dtype(self) -> torch.dtype:
        """The real dtype of the fields it applies to."""
        v = self.vals
        if cplx.is_cf(v):
            return v.dtype
        return torch.float64 if v.dtype == torch.complex128 else torch.float32

    @property
    def k_max(self) -> int:
        return self.vals.shape[1]

    @property
    def nnz(self) -> int:
        """Padded nnz; the exact nnz when built from zero-free rows."""
        return int(self.vals.shape[0] * self.vals.shape[1])

    def apply(self, x):
        """SpMV / SpMM. x: (n_cols,) or stacked (..., n_cols); a complex
        tensor or a CF (the values must be of the same kind)."""
        cols = self.cols.long()
        if cplx.is_cf(x):
            v = cplx.ascf(self.vals)
            g = cplx.CF(x.re[..., cols], x.im[..., cols])
            return cplx.CF((v.re * g.re - v.im * g.im).sum(-1), (v.re * g.im + v.im * g.re).sum(-1))
        return (self.vals * x[..., cols]).sum(-1)

    def scale(self, s) -> "ELLOperator":
        """Scalar multiply (the reference's Sparse scale, Operator.h:538-544)."""
        return ELLOperator(self.vals * s, self.cols, self.n_cols)

    def to_dense(self) -> torch.Tensor:
        vals = self.vals
        if cplx.is_cf(vals):
            vals = torch.complex(vals.re, vals.im)
        n, k = vals.shape
        dense = torch.zeros((n, self.n_cols), dtype=vals.dtype, device=vals.device)
        rows = torch.arange(n, device=vals.device)[:, None].expand(n, k)
        return dense.index_put_((rows, self.cols.long()), vals, accumulate=True)

    @staticmethod
    def from_csr(indptr, indices, data, n_cols: int, dtype=None, cf: bool = False,
                 device=None) -> "ELLOperator":
        """Pad CSR rows to the longest row. Padding entries have value 0 and
        column = their own row (a valid gather index). ``dtype`` is the
        complex dtype (default: the data's), or with ``cf=True`` the real
        dtype of split re/im values (default float32). On ``device``
        (CUDA unless named)."""
        dev = cplx.resolve_device(device)
        indptr = np.asarray(indptr)
        n_rows = len(indptr) - 1
        counts = np.diff(indptr)
        k = int(counts.max()) if n_rows else 0
        vals = np.zeros((n_rows, k), dtype=np.asarray(data).dtype)
        cols = np.tile(np.minimum(np.arange(n_rows), n_cols - 1)[:, None], (1, max(k, 1)))
        cols = cols.astype(np.int32)
        idx_in_row = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
        row_of = np.repeat(np.arange(n_rows), counts)
        vals[row_of, idx_in_row] = data
        cols[row_of, idx_in_row] = np.asarray(indices).astype(np.int32)
        cols_t = torch.as_tensor(cols).to(dev)
        if cf:
            return ELLOperator(cplx.from_numpy(vals, dtype or torch.float32, dev), cols_t,
                               int(n_cols))
        v = torch.as_tensor(vals).to(dev)
        return ELLOperator(v if dtype is None else v.to(dtype), cols_t, int(n_cols))
