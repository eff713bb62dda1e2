"""Linear-operator protocol.

Counterpart of ``mgpgcr_tpu/ops/base.py`` (the reference's ``Operator<T>``,
Operator.h:16-29): an operator is an object with an ``apply`` method; a
solver exposes ``as_preconditioner`` to compose with another solver.
"""

from __future__ import annotations


class LinearOperator:
    """Callable-apply interface of ``Operator::operator()`` (Operator.h:21)."""

    def apply(self, x):  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x):
        return self.apply(x)

    @property
    def shape(self) -> tuple[int, int]:  # pragma: no cover
        raise NotImplementedError
