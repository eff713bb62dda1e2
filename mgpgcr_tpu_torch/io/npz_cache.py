"""Binary cache of an ELL matrix as an ``.npz`` archive.

Counterpart of ``mgpgcr_tpu/io/npz_cache.py``, with the same schema
(``vals`` complex ``(n_rows, K)``, ``cols`` int32 ``(n_rows, K)``,
``n_cols`` a 0-d integer), so a file written by either package loads in
the other. The reference caches parsed matrices as text (Parse.cpp:39-59);
this loads in milliseconds.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.ops.ell import ELLOperator


def save_ell_npz(path: str | os.PathLike, op: ELLOperator) -> None:
    vals = op.vals
    vals = cplx.to_numpy(vals) if cplx.is_cf(vals) else vals.detach().cpu().numpy()
    np.savez_compressed(path, vals=vals, cols=op.cols.detach().cpu().numpy().astype(np.int32),
                        n_cols=np.asarray(op.n_cols))


def load_ell_npz(path: str | os.PathLike, dtype=None, device=None) -> ELLOperator:
    """The cached ELL on ``device`` (CUDA unless named); ``dtype`` casts the
    complex values (e.g. ``torch.complex64``)."""
    dev = cplx.resolve_device(device)
    with np.load(path) as z:
        vals = torch.as_tensor(z["vals"]).to(dev)
        return ELLOperator(vals if dtype is None else vals.to(dtype),
                           torch.as_tensor(z["cols"]).to(dev), int(z["n_cols"]))
