"""Build and load the hand-written CUDA kernels.

All sources in ``mgpgcr_tpu_torch/csrc/*.cu`` compile in ONE ``nvcc``
call into one shared library with a plain C interface (no PyTorch
headers), loaded with ``ctypes``. The build happens at first use, into
``mgpgcr_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
keyed by a hash of the sources, so an edited source rebuilds. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# extern "C" signatures of csrc/*.cu; every function returns a cudaError_t
_SIGNATURES = {
    # psi re/im, links re/im, out re/im, k (nullable), T, Z, Y, X,
    # rows, bf16 links, anti_t, stream
    "mg_dslash": [_P] * 7 + [_I] * 7 + [_P],
    # psi re/im, mu-major links re/im, out re/im, k (nullable), T, Z, Y, X,
    # bf16 links, stream
    "mg_dslash_mu": [_P] * 7 + [_I] * 5 + [_P],
    # r re/im, aps re/im, links re/im, alpha, k, r' re/im, az re/im,
    # partials, res, S, lim, T, Z, Y, X, rows, bf16, anti_t, stream
    "mg_gcr_stream_step": [_P] * 14 + [_I] * 9 + [_P],
    # az re/im, r re/im (nullable), aps re/im, betas, partials, res, M, lim,
    # slot, stream
    "mg_ap_update": [_P] * 9 + [_L, _I, _I, _P],
    # x re/im, basis pointer table, wx, wp, x' re/im, p0' re/im, M, nb, stream
    "mg_basis_flush": [_P] * 9 + [_L, _I, _P],
    # r re/im, aps re/im, alpha, partials, r' re/im, r2, M, slot, stream
    "mg_update_r": [_P] * 9 + [_L, _I, _P],
    # r re/im, aps re/im, z re/im, links re/im, k, az re/im, partials, res,
    # S, lim, T, Z, Y, X, rows, bf16, anti_t, stream
    "mg_gcr_z_step": [_P] * 13 + [_I] * 9 + [_P],
    # x re/im, r re/im, ps re/im, aps re/im, alpha, partials, x' re/im,
    # r' re/im, r2, M, slot, stream
    "mg_update_xr": [_P] * 15 + [_L, _I, _P],
    # aps re/im, az re/im, partials, out, M, S, lim, stream
    "mg_beta_dots": [_P] * 6 + [_L, _I, _I, _P],
    # z re/im, az re/im, r re/im (nullable), ps re/im, aps re/im, betas,
    # partials, res, M, lim, slot, stream
    "mg_dir_update": [_P] * 13 + [_L, _I, _I, _P],
    # q re/im, x re/im, partials, out re/im, ne, T, Z, Y, X, bt, bz, by, bx,
    # bf16 basis, stream
    "mg_restrict": [_P] * 7 + [_I] * 10 + [_P],
    # q re/im, c re/im, base re/im (nullable), out re/im, damping, ne, T, Z,
    # Y, X, bt, bz, by, bx, bf16 basis, stream
    "mg_prolong": [_P] * 8 + [_F] + [_I] * 10 + [_P],
    # blocks re/im, x re/im, y re/im, nb, K, ne, nd, d0, d1, d2, d3, bf16
    # blocks, stream
    "mg_stencil_spmv": [_P] * 6 + [_I] * 9 + [_P],
    # psi re/im, links re/im, out re/im, k (nullable), T, Z, Y, X, rows,
    # bf16 links, ghost table (12 pointers, common.cuh Halo), stream
    "mg_dslash_dist": [_P] * 7 + [_I] * 6 + [_P, _P],
    # as mg_gcr_stream_step without anti_t, plus the ghost table
    "mg_gcr_stream_step_dist": [_P] * 14 + [_I] * 8 + [_P, _P],
    # b re/im, x re/im, r re/im, scalars, hist, it, partials, ticket, M, S,
    # max_iter, stream
    "mg_coarse_gcr_start": [_P] * 11 + [_L, _I, _I, _P],
    # aps re/im, az re/im, scalars, partials, ticket, M, S, lim, stream
    "mg_coarse_gcr_dots": [_P] * 7 + [_L, _I, _I, _P],
    # r re/im, az re/im, ps re/im, aps re/im, scalars, it, partials, ticket,
    # M, S, lim, slot, clear, tol2, max_iter, stream
    "mg_coarse_gcr_dir": [_P] * 12 + [_L] + [_I] * 4 + [_F, _I, _P],
    # x re/im, r re/im, ps re/im, aps re/im, scalars, hist, it, going,
    # partials, ticket, M, S, slot, tol2, max_iter, stream
    "mg_coarse_gcr_update": [_P] * 14 + [_L, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_library(verbose: bool = False) -> tuple[Path, str]:
    """Compile every ``csrc/*.cu`` in one ``nvcc`` call (skipped when the
    library of these exact sources exists). Returns the library's path and
    the compiler's messages (``-Xptxas -v`` register and spill report when
    ``verbose``)."""
    files = sources() + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for f in files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = BUILD_DIR / f"libmgpgcr_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mg_error_string.argtypes = [ctypes.c_int]
            lib.mg_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one extern "C" launcher and raise if the launch failed."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.mg_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def count(wrapper, n: int = 1) -> None:
    """n more launches of ``wrapper``'s kernel; safe from several threads."""
    with _count_lock:
        wrapper.launches += n


def stream(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def pairs(z: torch.Tensor) -> torch.Tensor:
    """The (re, im) float pairs of a complex tensor, for a kernel pointer
    (a lazily conjugated tensor is materialised first). The caller keeps
    the result alive across the launch."""
    return torch.view_as_real(z.resolve_conj())


def check_cuda(*tensors, dtypes=None) -> None:
    """The kernels take contiguous tensors on one CUDA device, of the given
    dtypes (f32 by default); raise on anything else."""
    dtypes = dtypes or (torch.float32,)
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"kernel takes {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")
    if tensors[0].numel() >= 2**31:
        raise ValueError("kernel index arithmetic is 32-bit")


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (run the plain version); raise for a mix or another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(kinds)}: need all cpu or all cuda")
