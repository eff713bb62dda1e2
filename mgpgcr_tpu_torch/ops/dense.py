"""Dense complex operator.

Counterpart of ``mgpgcr_tpu/ops/dense.py`` (the reference's ``Dense<T>``,
Operator.h:33-190). The matrix is one complex tensor; the matvec is a
plain matrix product (``torch.matmul``), as the JAX package leaves it to
XLA: it is no kernel of the port.
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

    def apply(self, x):
        """Matvec (Operator.h:160-173) on a complex tensor or a CF, flat
        (n,) or stacked (..., n)."""
        if not cplx.is_cf(x):
            return x @ self.a.T
        y = torch.complex(x.re, x.im).to(self.a.dtype) @ self.a.T
        return cplx.CF(y.real.contiguous(), y.imag.contiguous())
