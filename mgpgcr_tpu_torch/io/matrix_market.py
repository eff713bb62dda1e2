"""MatrixMarket (.mtx) coordinate-format reader.

Counterpart of ``mgpgcr_tpu/io/matrix_market.py`` (the reference's
``parse_data``, Parse.cpp:10-62): ``%`` comment lines, ``rows cols nnz``,
then 1-based triplets; complex, real, integer and pattern fields;
symmetric, Hermitian and skew-symmetric storage mirrored. The native
parser reads it when it is available, else numpy (pattern fields always).
"""

from __future__ import annotations

import os

import numpy as np

from mgpgcr_tpu_torch.io import native_parse
from mgpgcr_tpu_torch.ops.coo import COOMatrix


def _mirror(rows, cols, vals, hermitian: bool, skew: bool):
    off = rows != cols
    mirror = vals[off]
    if hermitian:
        mirror = np.conj(mirror)
    elif skew:
        mirror = -mirror
    return (np.concatenate([rows, cols[off]]), np.concatenate([cols, rows[off]]),
            np.concatenate([vals, mirror]))


def read_matrix_market(path: str | os.PathLike) -> COOMatrix:
    fast = native_parse.read_mtx_native(str(path))
    if fast is not None:
        rows, cols, vals, shape, symmetric, hermitian, skew = fast
        if symmetric:
            rows, cols, vals = _mirror(rows, cols, vals, hermitian, skew)
        return COOMatrix(rows, cols, vals, shape)
    return _read_numpy(path)


def _read_numpy(path: str | os.PathLike) -> COOMatrix:
    with open(path, "r") as f:
        first = f.readline()
        field = "real"
        if first.startswith("%%MatrixMarket"):
            toks = first.lower().split()
            for cand in ("complex", "real", "integer", "pattern"):
                if cand in toks:
                    field = cand
            skew = "skew-symmetric" in toks
            symmetric = "symmetric" in toks or "hermitian" in toks or skew
            hermitian = "hermitian" in toks
        else:
            symmetric = hermitian = skew = False
            f.seek(0)
        line = f.readline()
        while line.lstrip().startswith("%"):
            line = f.readline()
        nrow, ncol, nnz = (int(t) for t in line.split()[:3])
        body = f.read()

    flat = np.array(body.split(), dtype=np.float64)
    per = {"complex": 4, "real": 3, "integer": 3, "pattern": 2}[field]
    if len(flat) != per * nnz:
        raise ValueError("malformed MatrixMarket body")
    flat = flat.reshape(nnz, per)
    rows = flat[:, 0].astype(np.int64) - 1  # 1-based (Parse.cpp:33-34)
    cols = flat[:, 1].astype(np.int64) - 1
    if field == "complex":
        vals = flat[:, 2] + 1j * flat[:, 3]
    elif field == "pattern":
        vals = np.ones(nnz, dtype=np.float64)
    else:
        vals = flat[:, 2]
    if symmetric:
        rows, cols, vals = _mirror(rows, cols, vals, hermitian, skew)
    return COOMatrix(rows, cols, vals, (nrow, ncol))
