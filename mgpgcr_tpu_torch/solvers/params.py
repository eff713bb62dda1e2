"""Solver configuration.

Counterpart of ``GCRParams`` and ``MGParams`` in
``mgpgcr_tpu/solvers/params.py`` (the reference's ``GCR_Param`` and
``MG_Param``, SolverParam.h:22-59), with the same fields and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class GCRParams:
    """Flexible-GCR controls.

    restart: wipe stored directions every `restart` iterations (GCR.h:277-283).
    truncation: keep only the last `truncation` directions (ring buffer,
      GCR.h:286-287). Mutually exclusive with restart (GCR.h:165).
    Stopping: relative residual ||r||/||rhs|| <= tol, or max_iter.
    residual_refresh: every N iterations replace the recursive residual by
      rhs - A x (0 = off).
    fused: run the solve through the hand-written kernels, on any operator
      (A = I - kD over ``CudaWilsonDirac`` also fuses the operator into the
      one-pass steps).
    unroll: the fused body's form, as in the JAX package: "cycles" runs
      restart cycles in the z-basis, "loop" one iteration at a time on the
      direction stacks; "auto" is "cycles" without a preconditioner and
      "loop" with one. Truncation, residual_refresh and restart > 16 always
      take the loop form.
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


@dataclass(frozen=True)
class MGParams:
    """Adaptive MG controls (MG_Param, SolverParam.h:38-59); the meaning of
    every field is that of the JAX package's ``MGParams``. The defaults
    are the reference's config of record (main.cpp:840-858) but for the
    smoother, which the reference has off (``smoother_gcr=None``).

    ``coarse_format``: "dense", "bsr" (block-ELL) or "stencil" (the
    block-stencil SpMV kernel on the card); "stencil" needs
    ``assembly="phased"``. ``n_level`` > 2 coarsens the block grid again by
    ``coarse_block`` per level. ``transfer_backend`` "auto" runs the
    transfer kernels on CUDA tensors and their plain versions on CPU
    tensors; the port has no other route, and other values raise for CUDA
    tensors. ``transfer_dtype`` is the storage dtype of the field-shaped
    basis (None, "bfloat16", "float32").
    """

    block: int = 4
    n_nullvecs: int = 10
    setup_gcr: GCRParams = field(
        default_factory=lambda: GCRParams(tol=1e-8, max_iter=10, restart=10)
    )
    setup_power_iters: int = 10
    coarse_gcr: GCRParams = field(
        default_factory=lambda: GCRParams(tol=1e-2, max_iter=50, restart=10)
    )
    smoother_gcr: GCRParams | None = field(
        default_factory=lambda: GCRParams(tol=0.0, max_iter=4, restart=4, fused=True)
    )
    n_pre_smooth: int = 1
    n_post_smooth: int = 1
    smoother: str = "gcr"  # "gcr" or "neumann"
    smoother_terms: int = 4
    coarse_format: str = "dense"
    assembly: str = "phased"
    correction_damping: float = 1.0
    n_level: int = 2
    coarse_block: int = 2
    transfer_backend: str = "auto"
    transfer_dtype: str | None = None

    @property
    def n_coarse_per_block(self) -> int:
        """ne = 2 * n_nullvecs after chiral doubling (MG.h:146-149)."""
        return 2 * self.n_nullvecs
