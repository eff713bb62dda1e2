"""COO triplets: what the MatrixMarket reader emits.

Counterpart of ``mgpgcr_tpu/ops/coo.py``. The reference builds CSR from
sorted triplet lists (Operator.h:251-294) and its MatrixMarket parser
emits triplets (Parse.cpp:28-35); conversion to CSR merges duplicates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mgpgcr_tpu_torch.ops.csr import CSRMatrix


@dataclass(frozen=True)
class COOMatrix:
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return len(self.vals)

    def to_csr(self, sum_duplicates: bool = True) -> CSRMatrix:
        return CSRMatrix.from_triplets(self.rows, self.cols, self.vals, self.shape,
                                       sum_duplicates)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out
