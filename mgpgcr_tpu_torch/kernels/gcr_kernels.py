"""K3, K4 and B2: the restart-cycle GCR algebra's wrappers and plain
versions.

``ap_update`` replaces ``mgpgcr_tpu/ops/pallas/gcr_kernels.py::ap_update``
(``_k3z_kernel``, as the one-pass solve calls it, with ``r=None``),
``basis_flush`` replaces ``::basis_flush`` (``_k4z_kernel``) and
``update_r`` replaces ``::update_r`` (``_k1r_kernel``); the kernels are
``csrc/gcr_kernels.cu``.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib

_MAX_BLOCKS = 132 * 16  # csrc/gcr_kernels.cu kMaxBlocks


def ap_update_plain(az, aps, betas, slot: int, lim: int):
    """Plain PyTorch version of K3; see :func:`ap_update`."""
    ap = az - cplx.weighted_stack_sum(betas[:lim], aps[:lim])
    aps[slot] = ap
    return aps, cplx.abs2_sum(ap)


def ap_update(az, aps, betas, slot: int, lim: int):
    """ap = az - sum_{j<lim} betas_j aps_j, written IN PLACE into stack row
    ``slot`` of ``aps`` (the JAX kernel aliases its output the same way);
    returns (aps, ||ap||^2). The search direction p itself is never formed
    (z-basis GCR). betas: complex (S,) tensor on the device."""
    if not _lib.on_cuda(az.re, az.im, aps.re, aps.im, betas):
        return ap_update_plain(az, aps, betas, slot, lim)
    s_rows = aps.shape[0]
    if aps.shape[1:] != az.shape or not 1 <= lim <= s_rows or not 0 <= slot < s_rows:
        raise ValueError(f"shapes az {az.shape}, aps {aps.shape}, slot {slot}, lim {lim}")
    _lib.check_cuda(az.re, az.im, aps.re, aps.im)
    _lib.check_cuda(betas, dtypes=(torch.complex64,))
    dev = az.device
    partials = torch.empty(_MAX_BLOCKS, dtype=torch.float64, device=dev)
    apn = torch.empty((), dtype=torch.float32, device=dev)
    bb = _lib.pairs(betas)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_ap_update", az.re.data_ptr(), az.im.data_ptr(), aps.re.data_ptr(),
            aps.im.data_ptr(), bb.data_ptr(), partials.data_ptr(),
            apn.data_ptr(), az.re.numel(), lim, slot, _lib.stream(az.re),
        )
    ap_update.launches += 1
    return aps, apn


ap_update.launches = 0


def basis_flush_plain(x, basis, wx, wp):
    """Plain PyTorch version of K4; see :func:`basis_flush`."""
    b = cplx.stack(basis)
    return x + cplx.weighted_stack_sum(wx, b), cplx.weighted_stack_sum(wp, b)


def basis_flush(x, basis, wx, wp):
    """(x', p0') from one pass over the basis fields [b_0 .. b_{nb-1}]:
    x' = x + sum wx_m b_m,  p0' = sum wp_m b_m.  wx, wp: complex (nb,)
    tensors on the device."""
    fields = [x.re, x.im] + [t for b in basis for t in (b.re, b.im)]
    if not _lib.on_cuda(*fields, wx, wp):
        return basis_flush_plain(x, basis, wx, wp)
    nb = len(basis)
    if any(b.shape != x.shape for b in basis) or wx.shape != (nb,) or wp.shape != (nb,):
        raise ValueError("basis fields and weights do not fit x")
    _lib.check_cuda(*fields)
    _lib.check_cuda(wx, wp, dtypes=(torch.complex64,))
    dev = x.device
    ptrs = [b.re.data_ptr() for b in basis] + [b.im.data_ptr() for b in basis]
    table = torch.tensor(ptrs, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    ox = cplx.CF(torch.empty_like(x.re), torch.empty_like(x.im))
    op = cplx.CF(torch.empty_like(x.re), torch.empty_like(x.im))
    wxb, wpb = _lib.pairs(wx), _lib.pairs(wp)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_basis_flush", x.re.data_ptr(), x.im.data_ptr(), table.data_ptr(),
            wxb.data_ptr(), wpb.data_ptr(),
            ox.re.data_ptr(), ox.im.data_ptr(), op.re.data_ptr(), op.im.data_ptr(),
            x.re.numel(), nb, _lib.stream(x.re),
        )
    basis_flush.launches += 1
    return ox, op


basis_flush.launches = 0


def update_r_plain(r, aps, slot: int, alpha):
    """Plain PyTorch version of B2; see :func:`update_r`."""
    rp = r - aps[slot] * alpha
    return rp, cplx.abs2_sum(rp)


def update_r(r, aps, slot: int, alpha):
    """(r', ||r'||^2) with r' = r - alpha aps[slot], a new field (the x
    half of the update is deferred to the cycle-end basis_flush). alpha:
    complex 0-d tensor on the device. The kernel's norm is f32 per thread
    and f64 from the warp on."""
    if not _lib.on_cuda(r.re, r.im, aps.re, aps.im, alpha):
        return update_r_plain(r, aps, slot, alpha)
    if aps.shape[1:] != r.shape or not 0 <= slot < aps.shape[0]:
        raise ValueError(f"shapes r {r.shape}, aps {aps.shape}, slot {slot}")
    _lib.check_cuda(r.re, r.im, aps.re, aps.im)
    _lib.check_cuda(alpha, dtypes=(torch.complex64,))
    dev = r.device
    partials = torch.empty(_MAX_BLOCKS, dtype=torch.float64, device=dev)
    r2 = torch.empty((), dtype=torch.float32, device=dev)
    rp = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    ab = _lib.pairs(alpha)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_update_r", r.re.data_ptr(), r.im.data_ptr(), aps.re.data_ptr(),
            aps.im.data_ptr(), ab.data_ptr(), partials.data_ptr(), rp.re.data_ptr(),
            rp.im.data_ptr(), r2.data_ptr(), r.re.numel(), slot, _lib.stream(r.re),
        )
    update_r.launches += 1
    return rp, r2


update_r.launches = 0
