"""Residual-trace artifacts.

Counterpart of ``mgpgcr_tpu/utils/trace.py`` (the reference appends every
residual to a hardcoded ``convergence.txt``, GCR.h:168, quirk Q9). The
solver returns the history (``SolveResult.res_history``) and these helpers
persist it: a ``.npz`` with a JSON metadata blob, or one residual per line
in the reference's text form. The formats are the JAX package's, so a file
written by either package reads in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_residual_trace(
    path: str | os.PathLike,
    history,
    *,
    meta: dict | None = None,
    text_compat: bool = False,
) -> None:
    """Save a residual history (a tensor or an array; NaN slots past the
    last iteration are dropped). ``path`` ending in .txt (or
    ``text_compat``) writes one residual per line like the reference's
    convergence.txt; otherwise a .npz with a JSON metadata blob."""
    if hasattr(history, "detach"):
        history = history.detach().cpu().numpy()
    h = np.asarray(history, dtype=np.float64)
    h = h[~np.isnan(h)]
    path = str(path)
    if text_compat or path.endswith(".txt"):
        with open(path, "w") as f:
            for v in h:
                f.write(f"{v:.16e}\n")
        return
    np.savez(path, history=h, meta=json.dumps(meta or {}))


def load_residual_trace(path: str | os.PathLike):
    """Returns (history, meta_dict)."""
    path = str(path)
    if path.endswith(".txt"):
        return np.loadtxt(path, ndmin=1), {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"])) if "meta" in z else {}
        return z["history"], meta
