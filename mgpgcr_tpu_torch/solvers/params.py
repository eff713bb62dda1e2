"""Solver configuration.

Counterpart of ``GCRParams`` in ``mgpgcr_tpu/solvers/params.py`` (the
reference's ``GCR_Param``, SolverParam.h:22-35).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GCRParams:
    """Flexible-GCR controls.

    restart: wipe stored directions every `restart` iterations (GCR.h:277-283).
    truncation: keep only the last `truncation` directions (ring buffer,
      GCR.h:286-287). Mutually exclusive with restart (GCR.h:165).
    Stopping: relative residual ||r||/||rhs|| <= tol, or max_iter.
    residual_refresh: every N iterations replace the recursive residual by
      rhs - A x (0 = off).
    fused: run the restart-cycle solve through the hand-written kernels
      (the one-pass step, ap_update, basis_flush); needs ``restart`` <= 16,
      no residual_refresh, no preconditioner, and A = I - kD over
      ``CudaWilsonDirac``.
    unroll: the JAX package's choice of fused body form ("auto", "cycles",
      "loop"). The port has the cycles form only; "loop" is refused by the
      fused solve.
    """

    tol: float = 1e-13
    max_iter: int = 100
    restart: int = 0
    truncation: int = 0
    residual_refresh: int = 0
    fused: bool = False
    unroll: str = "auto"

    def __post_init__(self):
        if self.restart and self.truncation:
            raise ValueError("restart and truncation are mutually exclusive (GCR.h:165)")
        if self.unroll not in ("auto", "cycles", "loop"):
            raise ValueError(f"unroll must be auto, cycles or loop, not {self.unroll!r}")

    @property
    def storage_size(self) -> int:
        if self.restart:
            return self.restart
        if self.truncation:
            return self.truncation
        return self.max_iter
