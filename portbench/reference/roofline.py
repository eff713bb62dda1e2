"""Peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W) and the
least bytes of the operations whose rooflines the benchmark reports:
each input read once and each output written once, whatever a kernel
reads again. Counts come from shapes only, never from the program."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12

COMPLEX_BYTES = {"float32": 8, "bfloat16": 4, "float64": 16}


def sites(dims) -> int:
    return math.prod(dims)


def field_bytes(dims, dtype: str = "float32") -> int:
    """One spinor field: 4 spins x 3 colours per site."""
    return sites(dims) * 12 * COMPLEX_BYTES[dtype]


def link_bytes(dims, rows: int = 2, dtype: str = "float32") -> int:
    """The gauge field: 4 directions of ``rows`` x 3 complex per site."""
    return sites(dims) * 4 * rows * 3 * COMPLEX_BYTES[dtype]


def dslash_bytes(dims, rows: int = 2, dtype: str = "float32") -> int:
    """A psi: read psi and the links, write the result."""
    return 2 * field_bytes(dims) + link_bytes(dims, rows, dtype)


def gcr_iteration_bytes(dims, restart: int, rows: int = 2, dtype: str = "float32") -> float:
    """One iteration of restarted GCR(restart) without a preconditioner,
    averaged over the slots of a cycle. Iteration j (1..restart) reads r,
    the links and the j stored A p (alpha, the beta dots and the new
    direction all use them) and writes r' and the new A p; once a cycle,
    x += sum alpha_j p_j reads x and the restart + 1 basis fields and
    writes x and the next seed direction."""
    f = field_bytes(dims)
    mean_live = (restart + 1) / 2
    per_iter = (3 + mean_live) * f + link_bytes(dims, rows, dtype)
    per_cycle = (restart + 4) * f
    return per_iter + per_cycle / restart


def stencil_apply_bytes(n_blocks: int, ne: int, slots: int = 9, dtype: str = "float32") -> int:
    """y = C x for a block stencil of ``n_blocks`` rows of ``slots`` blocks
    of ne x ne: read every block and x, write y."""
    cb = COMPLEX_BYTES[dtype]
    return n_blocks * slots * ne * ne * cb + 2 * n_blocks * ne * cb


def share_percent(nbytes: float, seconds: float) -> float | None:
    """100 x (least time at the HBM peak) / (measured seconds); None when
    nothing was measured."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
