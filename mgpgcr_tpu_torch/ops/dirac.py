"""Wilson--Dirac wrapper A = I - k D.

Counterpart of ``mgpgcr_tpu/ops/dirac.py`` (the reference's ``DiracOp``,
Operator.h:105-574). ``k`` is held as a complex 0-d tensor on the hopping
operator's device, so kernels read it through a pointer and no apply
waits on the host.
"""

from __future__ import annotations

import dataclasses

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.ops.base import LinearOperator


@dataclasses.dataclass(frozen=True)
class DiracOperator(LinearOperator):
    d: LinearOperator  # hopping operator with ``device`` and ``dtype``
    k: torch.Tensor  # complex 0-d tensor (a Python number is converted)

    def __post_init__(self):
        cdt = cplx.complex_dtype(self.d.dtype)
        k = self.k
        if not isinstance(k, torch.Tensor):
            k = torch.tensor(complex(k), dtype=cdt)
        object.__setattr__(self, "k", k.to(self.d.device, cdt))

    @property
    def shape(self) -> tuple[int, int]:
        return self.d.shape

    def apply(self, x):
        """x - k D(x) (Operator.h:570-574); operators with ``apply_dirac``
        (the Dslash kernel) compute the whole expression in one pass."""
        if hasattr(self.d, "apply_dirac"):
            return self.d.apply_dirac(x, self.k)
        return x - self.d.apply(x) * self.k
