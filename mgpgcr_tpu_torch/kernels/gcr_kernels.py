"""The streaming GCR algebra's wrappers and plain versions.

The restart-cycle solve's kernels: ``ap_update`` replaces
``mgpgcr_tpu/ops/pallas/gcr_kernels.py::ap_update`` (``_k3z_kernel``,
K3, with and without ``r``), ``basis_flush`` replaces ``::basis_flush``
(``_k4z_kernel``, K4) and ``update_r`` replaces ``::update_r``
(``_k1r_kernel``, B2); their kernels are ``csrc/gcr_kernels.cu``. The loop
form's kernels, on the direction stacks ``ps`` and ``aps``: ``update_xr``
replaces ``::update_xr`` (``_k1_kernel``, B6), ``beta_dots`` replaces
``::beta_dots`` (``_k2_kernel``, B3) and ``dir_update`` replaces
``::dir_update`` (``_k3_kernel``, B7); their kernels are
``csrc/gcr_loop.cu``.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib

_MAX_BLOCKS = 132 * 16  # csrc/gcr_kernels.cu and csrc/gcr_loop.cu kMaxBlocks


def _ptr(f, part: str):
    """Pointer of a CF's re or im plane, None (NULL) for an absent field."""
    return None if f is None else getattr(f, part).data_ptr()


def ap_update_plain(az, aps, betas, slot: int, lim: int, r=None):
    """Plain PyTorch version of K3; see :func:`ap_update`."""
    ap = az - cplx.weighted_stack_sum(betas[:lim], aps[:lim])
    aps[slot] = ap
    if r is None:
        return aps, cplx.abs2_sum(ap)
    return aps, cplx.abs2_sum(ap), cplx.vdot(ap, r)


def ap_update(az, aps, betas, slot: int, lim: int, r=None):
    """ap = az - sum_{j<lim} betas_j aps_j, written IN PLACE into stack row
    ``slot`` of ``aps`` (the JAX kernel aliases its output the same way);
    returns (aps, ||ap||^2), and with ``r`` given (aps, ||ap||^2, <ap, r>),
    next iteration's alpha numerator. The search direction p itself is
    never formed (z-basis GCR). betas: complex (S,) tensor on the device."""
    fields = [az.re, az.im, aps.re, aps.im] + ([] if r is None else [r.re, r.im])
    if not _lib.on_cuda(*fields, betas):
        return ap_update_plain(az, aps, betas, slot, lim, r)
    s_rows = aps.shape[0]
    if (aps.shape[1:] != az.shape or (r is not None and r.shape != az.shape)
            or not 1 <= lim <= s_rows or not 0 <= slot < s_rows):
        raise ValueError(f"shapes az {az.shape}, aps {aps.shape}, slot {slot}, lim {lim}")
    _lib.check_cuda(*fields)
    _lib.check_cuda(betas, dtypes=(torch.complex64,))
    dev = az.device
    nv = 1 if r is None else 3
    partials = torch.empty(_MAX_BLOCKS * nv, dtype=torch.float64, device=dev)
    res = torch.empty(nv, dtype=torch.float32, device=dev)
    bb = _lib.pairs(betas)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_ap_update", az.re.data_ptr(), az.im.data_ptr(), _ptr(r, "re"), _ptr(r, "im"),
            aps.re.data_ptr(), aps.im.data_ptr(), bb.data_ptr(), partials.data_ptr(),
            res.data_ptr(), az.re.numel(), lim, slot, _lib.stream(az.re),
        )
    ap_update.launches += 1
    if r is None:
        return aps, res[0]
    return aps, res[2], torch.view_as_complex(res[:2])


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


def update_xr_plain(x, r, ps, aps, slot: int, alpha):
    """Plain PyTorch version of B6; see :func:`update_xr`."""
    rp = r - aps[slot] * alpha
    return x + ps[slot] * alpha, rp, cplx.abs2_sum(rp)


def update_xr(x, r, ps, aps, slot: int, alpha):
    """(x', r', ||r'||^2) with x' = x + alpha ps[slot] and r' = r - alpha
    aps[slot], new fields: the loop form's solution and residual update on
    the direction stacks ps and aps. alpha: complex 0-d tensor on the
    device."""
    fields = [x.re, x.im, r.re, r.im, ps.re, ps.im, aps.re, aps.im]
    if not _lib.on_cuda(*fields, alpha):
        return update_xr_plain(x, r, ps, aps, slot, alpha)
    s_rows = ps.shape[0]
    if (r.shape != x.shape or ps.shape[1:] != x.shape or aps.shape != ps.shape
            or not 0 <= slot < s_rows):
        raise ValueError(f"shapes x {x.shape}, r {r.shape}, ps {ps.shape}, aps {aps.shape}, "
                         f"slot {slot}")
    _lib.check_cuda(*fields)
    _lib.check_cuda(alpha, dtypes=(torch.complex64,))
    dev = x.device
    partials = torch.empty(_MAX_BLOCKS, dtype=torch.float64, device=dev)
    r2 = torch.empty((), dtype=torch.float32, device=dev)
    xp = cplx.CF(torch.empty_like(x.re), torch.empty_like(x.im))
    rp = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    ab = _lib.pairs(alpha)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_update_xr", x.re.data_ptr(), x.im.data_ptr(), r.re.data_ptr(), r.im.data_ptr(),
            ps.re.data_ptr(), ps.im.data_ptr(), aps.re.data_ptr(), aps.im.data_ptr(),
            ab.data_ptr(), partials.data_ptr(), xp.re.data_ptr(), xp.im.data_ptr(),
            rp.re.data_ptr(), rp.im.data_ptr(), r2.data_ptr(), x.re.numel(), slot,
            _lib.stream(x.re),
        )
    update_xr.launches += 1
    return xp, rp, r2


update_xr.launches = 0


def beta_dots_plain(aps, az, lim: int | None = None):
    """Plain PyTorch version of B3; see :func:`beta_dots`."""
    s_rows = aps.shape[0]
    lim = s_rows if lim is None else lim
    raw = torch.zeros(s_rows, dtype=cplx.complex_dtype(az.dtype), device=az.device)
    raw[:lim] = cplx.conj_contract_stack(aps[:lim], az)
    return raw


def beta_dots(aps, az, lim: int | None = None):
    """raw_j = <aps_j, az> for the live prefix j < lim (default: the whole
    stack) as a complex (S,) tensor whose rows from lim on are zero; only
    the rows [0:lim] are read."""
    if not _lib.on_cuda(az.re, az.im, aps.re, aps.im):
        return beta_dots_plain(aps, az, lim)
    s_rows = aps.shape[0]
    lim = s_rows if lim is None else lim
    if aps.shape[1:] != az.shape or not 1 <= lim <= s_rows:
        raise ValueError(f"shapes az {az.shape}, aps {aps.shape}, lim {lim}")
    _lib.check_cuda(az.re, az.im, aps.re, aps.im)
    dev = az.device
    partials = torch.empty(_MAX_BLOCKS * 2 * lim, dtype=torch.float64, device=dev)
    out = torch.empty(2 * s_rows, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_beta_dots", aps.re.data_ptr(), aps.im.data_ptr(), az.re.data_ptr(),
            az.im.data_ptr(), partials.data_ptr(), out.data_ptr(), az.re.numel(), s_rows, lim,
            _lib.stream(az.re),
        )
    beta_dots.launches += 1
    return torch.view_as_complex(out.view(s_rows, 2))


beta_dots.launches = 0


def dir_update_plain(z, az, r, ps, aps, betas, slot: int, lim: int | None = None):
    """Plain PyTorch version of B7; see :func:`dir_update`. p and ap are
    formed from the old rows before row ``slot`` is assigned, which may lie
    inside the live prefix (truncation)."""
    lim = ps.shape[0] if lim is None else lim
    p = z - cplx.weighted_stack_sum(betas[:lim], ps[:lim])
    ap = az - cplx.weighted_stack_sum(betas[:lim], aps[:lim])
    ps[slot] = p
    aps[slot] = ap
    return ps, aps, cplx.abs2_sum(ap), cplx.vdot(ap, z if r is None else r)


def dir_update(z, az, r, ps, aps, betas, slot: int, lim: int | None = None):
    """p = z - sum_{j<lim} betas_j ps_j and ap = az - sum_{j<lim} betas_j
    aps_j, written IN PLACE into row ``slot`` of the stacks ps and aps
    (the slot may lie inside the live prefix); returns (ps, aps, ||ap||^2,
    <ap, r>). ``r=None`` marks the unpreconditioned iteration, where z is r:
    the dot is taken against z. betas: complex (S,) tensor on the device;
    lim defaults to the whole stack."""
    fields = [z.re, z.im, az.re, az.im, ps.re, ps.im, aps.re, aps.im]
    fields += [] if r is None else [r.re, r.im]
    if not _lib.on_cuda(*fields, betas):
        return dir_update_plain(z, az, r, ps, aps, betas, slot, lim)
    s_rows = ps.shape[0]
    lim = s_rows if lim is None else lim
    if (az.shape != z.shape or (r is not None and r.shape != z.shape)
            or ps.shape[1:] != z.shape or aps.shape != ps.shape
            or not 1 <= lim <= s_rows or not 0 <= slot < s_rows):
        raise ValueError(f"shapes z {z.shape}, ps {ps.shape}, aps {aps.shape}, slot {slot}, "
                         f"lim {lim}")
    _lib.check_cuda(*fields)
    _lib.check_cuda(betas, dtypes=(torch.complex64,))
    dev = z.device
    partials = torch.empty(_MAX_BLOCKS * 3, dtype=torch.float64, device=dev)
    res = torch.empty(3, dtype=torch.float32, device=dev)
    bb = _lib.pairs(betas)
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_dir_update", z.re.data_ptr(), z.im.data_ptr(), az.re.data_ptr(),
            az.im.data_ptr(), _ptr(r, "re"), _ptr(r, "im"), ps.re.data_ptr(), ps.im.data_ptr(),
            aps.re.data_ptr(), aps.im.data_ptr(), bb.data_ptr(), partials.data_ptr(),
            res.data_ptr(), z.re.numel(), lim, slot, _lib.stream(z.re),
        )
    dir_update.launches += 1
    return ps, aps, res[2], torch.view_as_complex(res[:2])


dir_update.launches = 0
