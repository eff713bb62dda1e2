"""Dense complex operator.

Counterpart of ``mgpgcr_tpu/ops/dense.py`` (the reference's ``Dense<T>``,
Operator.h:33-190): matvec, add, subtract, matmul, conjugate transpose,
element access. The matrix is one complex tensor; the matvec is a plain
matrix product (``torch.matmul``), as the JAX package leaves it to XLA: it
is no kernel of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.ops.base import LinearOperator


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    a: torch.Tensor  # (m, n) complex

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.a.shape)

    @property
    def device(self) -> torch.device:
        return self.a.device

    @property
    def dtype(self) -> torch.dtype:
        """The real dtype of the fields it applies to."""
        return torch.float64 if self.a.dtype == torch.complex128 else torch.float32

    def apply(self, x):
        """Matvec (Operator.h:160-173) on a complex tensor or a CF, flat
        (n,) or stacked (..., n)."""
        if not cplx.is_cf(x):
            return x @ self.a.T
        y = torch.complex(x.re, x.im).to(self.a.dtype) @ self.a.T
        return cplx.CF(y.real.contiguous(), y.imag.contiguous())

    def val_at(self, row: int, col: int):
        return self.a[row, col]

    def __add__(self, other: "DenseOperator") -> "DenseOperator":
        return DenseOperator(self.a + other.a)

    def __sub__(self, other: "DenseOperator") -> "DenseOperator":
        return DenseOperator(self.a - other.a)

    def matmul(self, other: "DenseOperator") -> "DenseOperator":
        """Dense @ dense (Operator.h:150-157)."""
        return DenseOperator(self.a @ other.a)

    def dagger(self) -> "DenseOperator":
        """Conjugate transpose (Operator.h:176-183)."""
        return DenseOperator(self.a.mH.contiguous())
