"""Linear-operator protocol.

Counterpart of ``mgpgcr_tpu/ops/base.py`` (the reference's ``Operator<T>``,
Operator.h:16-29): an operator is an object with an ``apply`` method; a
solver exposes ``as_preconditioner`` to compose with another solver;
``FunctionOperator`` wraps a plain function.
"""

from __future__ import annotations

from typing import Callable


class LinearOperator:
    """Callable-apply interface of ``Operator::operator()`` (Operator.h:21)."""

    def apply(self, x):  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x):
        return self.apply(x)

    @property
    def shape(self) -> tuple[int, int]:  # pragma: no cover
        raise NotImplementedError

    @property
    def dim(self) -> int:
        """Square-operator dimension (Operator::get_dim, Operator.h:24)."""
        return self.shape[0]


class FunctionOperator(LinearOperator):
    """Wrap a function of one field as a (matrix-free) operator."""

    def __init__(self, fn: Callable, dim: int):
        self._fn = fn
        self._dim = dim

    def apply(self, x):
        return self._fn(x)

    @property
    def shape(self) -> tuple[int, int]:
        return (self._dim, self._dim)
