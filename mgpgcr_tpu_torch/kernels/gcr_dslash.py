"""K2 and B9: the one-pass GCR steps' wrappers and their plain versions.

``gcr_stream_step`` replaces
``mgpgcr_tpu/ops/pallas/gcr_dslash.py::gcr_stream_step``
(``_gcr_step_kernel``) and ``gcr_z_step`` replaces ``::gcr_z_step``
(``_gcr_z_kernel``); both kernels are one template in
``csrc/gcr_dslash.cu``. K2 recomputes the updated residual at each stencil
neighbour instead of running a separate residual pass; B9's stencil input
is the preconditioner's output z.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib
from mgpgcr_tpu_torch.kernels.dslash import dslash_plain

_THREADS = 256  # csrc/common.cuh kThreads


def _dots_plain(aps, lim: int, az, v):
    """raw = <aps[0:lim], az> (complex (S,)) and apr = <aps[0:lim], v>,
    <az, v> (complex (S+1,): rows [0:lim] and S); the other rows are zero."""
    s_rows = aps.shape[0]
    cdt = cplx.complex_dtype(v.dtype)
    raw = torch.zeros(s_rows, dtype=cdt, device=v.device)
    apr = torch.zeros(s_rows + 1, dtype=cdt, device=v.device)
    live = aps[:lim]
    raw[:lim] = cplx.conj_contract_stack(live, az)
    apr[:lim] = cplx.conj_contract_stack(live, v)
    apr[s_rows] = cplx.vdot(az, v)
    return raw, apr


def _check_step(links, fields, aps, lim: int, mesh, scalars) -> None:
    """The step kernels' shape, dtype and device contract; raise on the rest."""
    t, z, y, xx = mesh.spacetime_dims
    shape = (4, 3, t, z, y * xx)
    if any(f.shape != shape for f in fields) or aps.shape[1:] != shape or not (
        1 <= lim <= aps.shape[0]
    ):
        raise ValueError(f"shapes {[f.shape for f in fields]}, aps {aps.shape}, lim {lim} "
                         f"do not fit {mesh.dims}")
    if links.shape[0] != t or links.shape[2] not in (2, 3):
        raise ValueError(f"links shape {links.shape} does not fit {mesh.dims}")
    _lib.check_cuda(*(p for f in fields for p in (f.re, f.im)), aps.re, aps.im)
    _lib.check_cuda(links.re, links.im, dtypes=(torch.float32, torch.bfloat16))
    _lib.check_cuda(*scalars, dtypes=(torch.complex64,))


def _step_outputs(mesh, s_rows: int, dev):
    """Scratch of a step launch: block partials and the reduced values, in
    the kernel's layout raw (S complex), apr (S + 1 complex), r2."""
    nv = 4 * s_rows + 3
    nblocks = (mesh.n_sites + _THREADS - 1) // _THREADS
    partials = torch.empty(nblocks * nv, dtype=torch.float64, device=dev)
    return partials, torch.empty(nv, dtype=torch.float32, device=dev)


def _split_res(res, s_rows: int):
    raw = torch.view_as_complex(res[: 2 * s_rows].view(s_rows, 2))
    apr = torch.view_as_complex(res[2 * s_rows : 4 * s_rows + 2].view(s_rows + 1, 2))
    return raw, apr


def gcr_stream_step_plain(links, r, aps, alpha, k, lim: int, mesh, anti_t: bool = False):
    """Plain PyTorch version of K2; see :func:`gcr_stream_step`."""
    rp = r - aps[lim - 1] * alpha
    az = dslash_plain(links, rp, mesh, k, anti_t)
    return (rp, az, cplx.abs2_sum(rp), *_dots_plain(aps, lim, az, rp))


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
    _check_step(links, [r], aps, lim, mesh, [alpha, k])
    t, z, y, xx = mesh.spacetime_dims
    s_rows = aps.shape[0]
    rp = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    az = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    partials, res = _step_outputs(mesh, s_rows, r.device)
    ab, kb = _lib.pairs(alpha), _lib.pairs(k)
    with torch.cuda.device(r.device):
        _lib.launch(
            "mg_gcr_stream_step", r.re.data_ptr(), r.im.data_ptr(), aps.re.data_ptr(),
            aps.im.data_ptr(), links.re.data_ptr(), links.im.data_ptr(),
            ab.data_ptr(), kb.data_ptr(),
            rp.re.data_ptr(), rp.im.data_ptr(), az.re.data_ptr(), az.im.data_ptr(),
            partials.data_ptr(), res.data_ptr(), s_rows, lim, t, z, y, xx, links.shape[2],
            int(links.dtype == torch.bfloat16), int(anti_t), _lib.stream(r.re),
        )
    _lib.count(gcr_stream_step)
    return (rp, az, res[4 * s_rows + 2], *_split_res(res, s_rows))


gcr_stream_step.launches = 0


def gcr_z_step_plain(links, z, r, aps, k, lim: int, mesh, anti_t: bool = False):
    """Plain PyTorch version of B9; see :func:`gcr_z_step`."""
    az = dslash_plain(links, z, mesh, k, anti_t)
    return (az, *_dots_plain(aps, lim, az, r))


def gcr_z_step(links, z, r, aps, k, lim: int, mesh, anti_t: bool = False):
    """(az, raw, apr) for one PRECONDITIONED GCR iteration, z = M(r):

        az  = (I - k D) z
        raw = <aps[0:lim], az>           (complex (S,), zeros from lim on)
        apr = <aps[0:lim], r>, <az, r>   (complex (S+1,): rows [0:lim] and S)

    Shapes as in :func:`gcr_stream_step`. CPU tensors take
    :func:`gcr_z_step_plain`; CUDA tensors launch the kernel or raise."""
    tensors = [links.re, links.im, z.re, z.im, r.re, r.im, aps.re, aps.im, k]
    if not _lib.on_cuda(*tensors):
        return gcr_z_step_plain(links, z, r, aps, k, lim, mesh, anti_t)
    _check_step(links, [z, r], aps, lim, mesh, [k])
    t, zd, y, xx = mesh.spacetime_dims
    s_rows = aps.shape[0]
    az = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    partials, res = _step_outputs(mesh, s_rows, r.device)
    kb = _lib.pairs(k)
    with torch.cuda.device(r.device):
        _lib.launch(
            "mg_gcr_z_step", r.re.data_ptr(), r.im.data_ptr(), aps.re.data_ptr(),
            aps.im.data_ptr(), z.re.data_ptr(), z.im.data_ptr(), links.re.data_ptr(),
            links.im.data_ptr(), kb.data_ptr(), az.re.data_ptr(), az.im.data_ptr(),
            partials.data_ptr(), res.data_ptr(), s_rows, lim, t, zd, y, xx, links.shape[2],
            int(links.dtype == torch.bfloat16), int(anti_t), _lib.stream(r.re),
        )
    _lib.count(gcr_z_step)
    return (az, *_split_res(res, s_rows))


gcr_z_step.launches = 0
