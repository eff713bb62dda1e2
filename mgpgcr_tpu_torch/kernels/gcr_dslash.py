"""K2: the one-pass GCR step's wrapper and its plain version.

``gcr_stream_step`` replaces
``mgpgcr_tpu/ops/pallas/gcr_dslash.py::gcr_stream_step``
(``_gcr_step_kernel``); the kernel is ``csrc/gcr_dslash.cu``, which
recomputes the updated residual at each stencil neighbour instead of
running a separate residual pass.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib
from mgpgcr_tpu_torch.kernels.dslash import dslash_plain

_THREADS = 256  # csrc/common.cuh kThreads


def gcr_stream_step_plain(links, r, aps, alpha, k, lim: int, mesh, anti_t: bool = False):
    """Plain PyTorch version of K2; see :func:`gcr_stream_step`."""
    s_rows = aps.shape[0]
    rp = r - aps[lim - 1] * alpha
    az = dslash_plain(links, rp, mesh, k, anti_t)
    cdt = cplx.complex_dtype(r.dtype)
    raw = torch.zeros(s_rows, dtype=cdt, device=r.device)
    apr = torch.zeros(s_rows + 1, dtype=cdt, device=r.device)
    live = aps[:lim]
    raw[:lim] = cplx.conj_contract_stack(live, az)
    apr[:lim] = cplx.conj_contract_stack(live, rp)
    apr[s_rows] = cplx.vdot(az, rp)
    return rp, az, cplx.abs2_sum(rp), raw, apr


def gcr_stream_step(links, r, aps, alpha, k, lim: int, mesh, anti_t: bool = False):
    """(r', az, ||r'||^2, raw, apr) for one unpreconditioned GCR iteration:

        r'  = r - alpha aps[lim-1]
        az  = (I - k D) r'
        raw = <aps[0:lim], az>            (complex (S,), zeros from lim on)
        apr = <aps[0:lim], r'>, <az, r'>  (complex (S+1,): rows [0:lim] and S)

    links: t-major (T, 4, R, 3, Z, V) CF; r: (4, 3, T, Z, V) CF; aps:
    (S, 4, 3, T, Z, V) CF; alpha, k: complex 0-d tensors on the device.
    CPU tensors take :func:`gcr_stream_step_plain`; CUDA tensors launch the
    kernel or raise."""
    tensors = [links.re, links.im, r.re, r.im, aps.re, aps.im, alpha, k]
    if not _lib.on_cuda(*tensors):
        return gcr_stream_step_plain(links, r, aps, alpha, k, lim, mesh, anti_t)
    t, z, y, xx = mesh.spacetime_dims
    s_rows = aps.shape[0]
    if r.shape != (4, 3, t, z, y * xx) or aps.shape[1:] != r.shape or not 1 <= lim <= s_rows:
        raise ValueError(f"shapes r {r.shape}, aps {aps.shape}, lim {lim} do not fit")
    if links.shape[0] != t or links.shape[2] not in (2, 3):
        raise ValueError(f"links shape {links.shape} does not fit {mesh.dims}")
    _lib.check_cuda(r.re, r.im, aps.re, aps.im)
    _lib.check_cuda(links.re, links.im, dtypes=(torch.float32, torch.bfloat16))
    _lib.check_cuda(alpha, k, dtypes=(torch.complex64,))
    dev = r.device
    n_sites = t * z * y * xx
    nv = 4 * s_rows + 3
    nblocks = (n_sites + _THREADS - 1) // _THREADS
    rp = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    az = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    partials = torch.empty(nblocks * nv, dtype=torch.float64, device=dev)
    res = torch.empty(nv + 1, dtype=torch.float32, device=dev)
    ab, kb = _lib.pairs(alpha), _lib.pairs(k)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_gcr_stream_step", r.re.data_ptr(), r.im.data_ptr(), aps.re.data_ptr(),
            aps.im.data_ptr(), links.re.data_ptr(), links.im.data_ptr(),
            ab.data_ptr(), kb.data_ptr(),
            rp.re.data_ptr(), rp.im.data_ptr(), az.re.data_ptr(), az.im.data_ptr(),
            partials.data_ptr(), res.data_ptr(), s_rows, lim, t, z, y, xx, links.shape[2],
            int(links.dtype == torch.bfloat16), int(anti_t), _lib.stream(r.re),
        )
    gcr_stream_step.launches += 1
    raw = torch.view_as_complex(res[: 2 * s_rows].view(s_rows, 2))
    apr = torch.view_as_complex(res[2 * s_rows : 4 * s_rows + 2].view(s_rows + 1, 2))
    return rp, az, res[4 * s_rows + 2], raw, apr


gcr_stream_step.launches = 0
