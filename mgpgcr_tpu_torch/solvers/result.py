"""Typed solve results (counterpart of ``mgpgcr_tpu/solvers/result.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: object  # the solution, a CF field on the solve's device
    converged: bool
    n_iters: int
    final_relres: float
    res_history: torch.Tensor  # (max_iter + 1,) relative residuals, NaN padded

    def history_list(self) -> list[float]:
        """Finite prefix of the residual history."""
        h = self.res_history.detach().cpu()
        return h[~torch.isnan(h)].tolist()
