"""Reader and writer of the reference's CSR text cache ("parsed.txt").

Counterpart of ``mgpgcr_tpu/io/parsed_txt.py``. Format (the reference's
``parse_data``, Parse.cpp:39-59):
  line 1: ``nrow ncol nnz``
  line 2: the CSR row pointers (``nrow`` or ``nrow + 1`` entries)
  then one line per non-zero: ``col (re,im)``.
The native parser (``io/native_parse.py``) reads and writes it when it is
available, else the numpy parser beside it, which is vectorised (the 4^4
fixture has 119,808 non-zeros).
"""

from __future__ import annotations

import os

import numpy as np

from mgpgcr_tpu_torch.io import native_parse
from mgpgcr_tpu_torch.ops.csr import CSRMatrix


def read_parsed_txt(path: str | os.PathLike) -> CSRMatrix:
    fast = native_parse.read_parsed_txt_native(str(path))
    if fast is not None:
        indptr, indices, data, shape = fast
        return CSRMatrix(indptr, indices, data, shape)
    return _read_numpy(path)


def _read_numpy(path: str | os.PathLike) -> CSRMatrix:
    with open(path, "r") as f:
        nrow, ncol, nnz = (int(t) for t in f.readline().split()[:3])
        row_line = f.readline()
        rest = f.read()
    indptr = np.array(row_line.split(), dtype=np.int64)
    if len(indptr) == nrow:  # the reference writes ROW[0..nrow-1]; append the end
        indptr = np.append(indptr, nnz)
    if len(indptr) != nrow + 1:
        raise ValueError("malformed row-pointer line")
    # entries look like "12 (-0.502679,0.364411)": strip the punctuation and
    # parse one flat float stream [col, re, im, col, re, im, ...]
    table = str.maketrans({"(": " ", ")": " ", ",": " "})
    flat = np.array(rest.translate(table).split(), dtype=np.float64)
    if len(flat) != 3 * nnz:
        raise ValueError(f"expected {3 * nnz} tokens, got {len(flat)}")
    flat = flat.reshape(nnz, 3)
    return CSRMatrix(indptr, flat[:, 0].astype(np.int64), flat[:, 1] + 1j * flat[:, 2],
                     (nrow, ncol))


def write_parsed_txt(path: str | os.PathLike, m: CSRMatrix) -> None:
    """Write the cache in the reference's exact layout (Parse.cpp:42-59)."""
    if not native_parse.write_parsed_txt_native(str(path), m.indptr, m.indices, m.data,
                                                m.shape):
        _write_numpy(path, m)


def _write_numpy(path: str | os.PathLike, m: CSRMatrix) -> None:
    with open(path, "w") as f:
        f.write(f"{m.shape[0]} {m.shape[1]} {m.nnz}\n")
        f.write(" ".join(str(int(r)) for r in m.indptr[:-1]) + " \n")
        for c, v in zip(m.indices, m.data):
            f.write(f"{int(c)} ({v.real:.6g},{v.imag:.6g})\n")
