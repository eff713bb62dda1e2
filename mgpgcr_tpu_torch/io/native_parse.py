"""ctypes bindings to the native C++ parser (``native/parse.cpp``).

Counterpart of ``mgpgcr_tpu/io/native_parse.py``; the same C++ source and
the same exported ABI (version 2), not a copy of it. The library is
``native/libmgpgcr_io.so`` when ``make -C native`` has built it; else it
is built at first use from ``native/parse.cpp`` into the package's
``_build/`` (one ``g++`` call with the Makefile's flags, keyed by a hash
of the source). When neither works (no compiler, no source), callers use
the numpy parsers, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "parse.cpp"
PREBUILT = _ROOT / "native" / "libmgpgcr_io.so"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]  # native/Makefile
ABI_VERSION = 2

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C")
_LL = ctypes.c_longlong
_LL3 = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "parse_parsed_txt_header": [ctypes.c_char_p, _LL3],
    "parse_parsed_txt_fill": [ctypes.c_char_p, _LL, _LL, _I64, _I64, _F64],
    "parse_mtx_header": [ctypes.c_char_p, _LL3, _LL3],
    "parse_mtx_fill": [ctypes.c_char_p, _LL, _LL, _I64, _I64, _F64],
    "write_parsed_txt_native": [ctypes.c_char_p, _LL, _LL, _LL, _I64, _I64, _F64],
}

_lock = threading.Lock()
_lib = None
_tried = False


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/parse.cpp`` into ``out_dir`` (skipped when the
    library of this exact source is there); returns its path."""
    src = SOURCE.read_bytes()
    out = Path(out_dir) / f"libmgpgcr_io_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/parse.cpp")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(path) -> ctypes.CDLL | None:
    """The library at ``path`` with its signatures bound, or None when it
    does not load or exports another ABI (a stale build)."""
    try:
        lib = ctypes.CDLL(str(path))
        lib.mgpgcr_io_abi_version.restype = ctypes.c_longlong
        if lib.mgpgcr_io_abi_version() != ABI_VERSION:
            return None
    except (OSError, AttributeError):
        return None
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def _library():
    """The prebuilt library, else one built from the source; None when
    neither is to be had (first call decides, then cached)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = load(PREBUILT) if PREBUILT.exists() else None
            if _lib is None and SOURCE.exists():
                try:
                    _lib = load(build())
                except RuntimeError:
                    _lib = None
        return _lib


def available() -> bool:
    return _library() is not None


def read_parsed_txt_native(path: str):
    """(indptr, indices, data, shape), or None without the library or when
    it fails to parse the file."""
    lib = _library()
    if lib is None:
        return None
    hdr = (ctypes.c_longlong * 3)()
    if lib.parse_parsed_txt_header(path.encode(), hdr) != 0:
        return None
    nrow, ncol, nnz = int(hdr[0]), int(hdr[1]), int(hdr[2])
    indptr = np.empty(nrow + 1, dtype=np.int64)
    indices = np.empty(nnz, dtype=np.int64)
    data_ri = np.empty(2 * nnz, dtype=np.float64)
    if lib.parse_parsed_txt_fill(path.encode(), nrow, nnz, indptr, indices, data_ri) != 0:
        return None
    return indptr, indices, data_ri[0::2] + 1j * data_ri[1::2], (nrow, ncol)


def read_mtx_native(path: str):
    """(rows, cols, vals, shape, symmetric, hermitian, skew), or None."""
    lib = _library()
    if lib is None:
        return None
    hdr = (ctypes.c_longlong * 4)()
    sym = (ctypes.c_longlong * 3)()
    if lib.parse_mtx_header(path.encode(), hdr, sym) != 0:
        return None
    nrow, ncol, nnz, field = (int(hdr[i]) for i in range(4))
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    data_ri = np.empty(2 * nnz, dtype=np.float64)
    if lib.parse_mtx_fill(path.encode(), nnz, field, rows, cols, data_ri) != 0:
        return None
    vals = data_ri[0::2] + 1j * data_ri[1::2] if field == 1 else data_ri[0::2].copy()
    return rows, cols, vals, (nrow, ncol), bool(sym[0]), bool(sym[1]), bool(sym[2])


def write_parsed_txt_native(path: str, indptr, indices, data, shape) -> bool:
    """Write the reference's cache layout; False without the library."""
    lib = _library()
    if lib is None:
        return False
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.asarray(data, dtype=np.complex128)
    data_ri = np.empty(2 * len(indices), dtype=np.float64)
    data_ri[0::2], data_ri[1::2] = data.real, data.imag
    return lib.write_parsed_txt_native(path.encode(), int(shape[0]), int(shape[1]),
                                       len(indices), indptr, indices, data_ri) == 0
