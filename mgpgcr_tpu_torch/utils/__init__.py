"""Observability and run utilities.

Counterpart of ``mgpgcr_tpu/utils``: structured JSON-lines run logs, phase
timers, residual-trace artifacts, ``torch.profiler`` hooks and the
roofline model of the Dslash and of one GCR iteration.
"""

from mgpgcr_tpu_torch.utils.logging import RunLogger, Timer
from mgpgcr_tpu_torch.utils.trace import save_residual_trace, load_residual_trace
from mgpgcr_tpu_torch.utils.profiling import (
    Roofline,
    annotate,
    chip_bandwidth,
    dslash_roofline,
    gcr_iteration_roofline,
    roofline,
    trace,
)

__all__ = [
    "RunLogger",
    "Timer",
    "save_residual_trace",
    "load_residual_trace",
    "Roofline",
    "annotate",
    "chip_bandwidth",
    "dslash_roofline",
    "gcr_iteration_roofline",
    "roofline",
    "trace",
]
