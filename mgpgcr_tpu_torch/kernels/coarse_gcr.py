"""The V-cycle's coarse GCR as hand-written kernels: wrappers and plain
versions.

``coarse_gcr_start``, ``coarse_gcr_dots``, ``coarse_gcr_dir`` and
``coarse_gcr_update`` run one restart cycle of restarted GCR on flat CF
vectors with every scalar of the recurrence on the device
(``CycleScalars``); ``solvers/mg.py::KernelCycle`` drives them. They
replace no TPU kernel: the JAX package's coarse GCR is XLA vector algebra.
Their kernels are ``csrc/coarse_gcr.cu``, which says what bounds them on an
H100 (launches and latency: the vectors are small and stay in L2) and what
the design does about it (one pass a step; the reduction's second stage and
the scalar work in the block that arrives last). CPU tensors take the plain
versions, in the fields' dtype.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib

_MAX_BLOCKS = 256  # csrc/coarse_gcr.cu kCgMaxBlocks
MAX_ROWS = 64  # csrc/coarse_gcr.cu kCgMaxRows: the most rows of a stack (restart)


def _tiny(dtype) -> float:
    """The guard of a division by a norm (as the generic loop's)."""
    return 1e-300 if dtype == torch.float64 else 1e-30


class CycleScalars:
    """The device scalars of one coarse GCR solve over stacks of ``S``
    rows (at most ``MAX_ROWS``), stopping at ``tol`` or ``max_iter``. ``vals`` is one block in the
    kernels' layout: the betas (S complex, as (re, im) pairs), alpha, the
    norms ||aps_j||^2 (``ap_norms``), r2, rhs_norm2 and the active flag (1
    or 0); beside it ``it`` (int64), ``going`` (bool), the history
    ``hist`` (max_iter + 1, NaN where not reached), and the kernels'
    partials and last-block ticket."""

    def __init__(self, S: int, tol: float, max_iter: int, dtype, device):
        if not 1 <= S <= MAX_ROWS:
            raise ValueError(f"stacks of 1 to {MAX_ROWS} rows, not {S}")
        self.S, self.max_iter = S, max_iter
        self.tol2 = tol**2
        self.vals = torch.zeros(3 * S + 5, dtype=dtype, device=device)
        self.it = torch.zeros((), dtype=torch.int64, device=device)
        self.going = torch.zeros((), dtype=torch.bool, device=device)
        self.hist = torch.full((max_iter + 1,), float("nan"), dtype=dtype, device=device)
        self.partials = torch.zeros(_MAX_BLOCKS * max(2 * S, 3), dtype=torch.float64,
                                    device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)

    @property
    def betas(self) -> torch.Tensor:
        return torch.view_as_complex(self.vals[: 2 * self.S].view(self.S, 2))

    @property
    def alpha(self) -> torch.Tensor:
        return torch.view_as_complex(self.vals[2 * self.S: 2 * self.S + 2])

    @property
    def ap_norms(self) -> torch.Tensor:
        return self.vals[2 * self.S + 2: 3 * self.S + 2]

    def _at(self, i: int) -> torch.Tensor:
        return self.vals[3 * self.S + 2 + i]

    @property
    def r2(self) -> torch.Tensor:
        return self._at(0)

    @property
    def rhs_norm2(self) -> torch.Tensor:
        return self._at(1)

    @property
    def active(self) -> torch.Tensor:
        return self._at(2)

    def running(self) -> torch.Tensor:
        """Not converged and under max_iter, as a device bool."""
        return (self.r2 > self.tol2 * self.rhs_norm2) & (self.it < self.max_iter)

    def _check(self, *fields) -> None:
        _lib.check_cuda(*fields)
        _lib.check_cuda(self.vals, self.hist)


def _launch(name: str, wrapper, like, *args) -> None:
    with torch.cuda.device(like.device):
        _lib.launch(name, *args, _lib.stream(like))
    _lib.count(wrapper)


def coarse_gcr_start_plain(b, x, r, sc: CycleScalars) -> None:
    """Plain PyTorch version of :func:`coarse_gcr_start`."""
    x.re.zero_()
    x.im.zero_()
    r.re.copy_(b.re)
    r.im.copy_(b.im)
    n = cplx.abs2_sum(b)
    sc.r2.copy_(n)
    sc.rhs_norm2.copy_(n)
    sc.it.zero_()
    sc.hist.fill_(float("nan"))
    sc.hist[0] = torch.sqrt(n / torch.clamp(n, min=_tiny(n.dtype)))


def coarse_gcr_start(b, x, r, sc: CycleScalars) -> None:
    """Open a solve of A x = b: x = 0 and r = b (in place), rhs_norm2 = r2
    = ||b||^2, it = 0, the history NaN but hist[0] = 1 (0 for b = 0)."""
    fields = (b.re, b.im, x.re, x.im, r.re, r.im)
    if not _lib.on_cuda(*fields, sc.vals):
        return coarse_gcr_start_plain(b, x, r, sc)
    if x.shape != b.shape or r.shape != b.shape:
        raise ValueError(f"shapes b {b.shape}, x {x.shape}, r {r.shape}")
    sc._check(*fields)
    _launch("mg_coarse_gcr_start", coarse_gcr_start, b.re, b.re.data_ptr(), b.im.data_ptr(),
            x.re.data_ptr(), x.im.data_ptr(), r.re.data_ptr(), r.im.data_ptr(),
            sc.vals.data_ptr(), sc.hist.data_ptr(), sc.it.data_ptr(), sc.partials.data_ptr(),
            sc.ticket.data_ptr(), b.re.numel(), sc.S, sc.max_iter)


coarse_gcr_start.launches = 0


def coarse_gcr_dots_plain(aps, az, lim: int, sc: CycleScalars) -> None:
    """Plain PyTorch version of :func:`coarse_gcr_dots`."""
    raw = cplx.conj_contract_stack(aps[:lim], az)
    norms = sc.ap_norms[:lim]
    betas = sc.betas
    betas.zero_()
    betas[:lim] = torch.where(norms > 0, raw * (1.0 / torch.clamp(norms, min=_tiny(norms.dtype))),
                              torch.zeros_like(raw))


def coarse_gcr_dots(aps, az, lim: int, sc: CycleScalars) -> None:
    """The betas beta_j = <aps_j, az> / ap_norms_j of the rows j < lim, zero
    where ap_norms_j is 0 and from lim on, into ``sc``."""
    fields = (aps.re, aps.im, az.re, az.im)
    if not _lib.on_cuda(*fields, sc.vals):
        return coarse_gcr_dots_plain(aps, az, lim, sc)
    if aps.shape != (sc.S,) + az.shape or not 1 <= lim <= sc.S:
        raise ValueError(f"shapes az {az.shape}, aps {aps.shape}, lim {lim}")
    sc._check(*fields)
    _launch("mg_coarse_gcr_dots", coarse_gcr_dots, az.re, aps.re.data_ptr(), aps.im.data_ptr(),
            az.re.data_ptr(), az.im.data_ptr(), sc.vals.data_ptr(), sc.partials.data_ptr(),
            sc.ticket.data_ptr(), az.re.numel(), sc.S, lim)


coarse_gcr_dots.launches = 0


def coarse_gcr_dir_plain(r, az, ps, aps, slot: int, lim: int, clear: bool,
                         sc: CycleScalars) -> None:
    """Plain PyTorch version of :func:`coarse_gcr_dir`. p and ap are formed
    from the old rows before row ``slot`` is assigned."""
    p, ap = r.clone(), az.clone()
    if lim:
        betas = sc.betas[:lim]
        p = p - cplx.weighted_stack_sum(betas, ps[:lim])
        ap = ap - cplx.weighted_stack_sum(betas, aps[:lim])
    ps[slot] = p
    aps[slot] = ap
    ap2, apr = cplx.abs2_sum(ap), cplx.vdot(ap, r)
    if clear:
        sc.ap_norms.zero_()
    sc.ap_norms[slot] = ap2
    active = sc.running()
    sc.active.copy_(active)
    sc.alpha.copy_(apr * (1.0 / torch.clamp(ap2, min=_tiny(ap2.dtype))) * active.to(ap2.dtype))


def coarse_gcr_dir(r, az, ps, aps, slot: int, lim: int, clear: bool, sc: CycleScalars) -> None:
    """p = r - sum_{j<lim} beta_j ps_j and ap = az - sum_{j<lim} beta_j aps_j
    into row ``slot`` of ps and aps (in place; the slot may lie inside the
    live prefix); ap_norms cleared first where ``clear`` (a restart), then
    ap_norms[slot] = ||ap||^2; the active flag (not converged, under
    max_iter) and alpha = <ap, r> / ||ap||^2, zero when not active."""
    fields = (r.re, r.im, az.re, az.im, ps.re, ps.im, aps.re, aps.im)
    if not _lib.on_cuda(*fields, sc.vals):
        return coarse_gcr_dir_plain(r, az, ps, aps, slot, lim, clear, sc)
    if (az.shape != r.shape or ps.shape != (sc.S,) + r.shape or aps.shape != ps.shape
            or not 0 <= lim <= sc.S or not 0 <= slot < sc.S):
        raise ValueError(f"shapes r {r.shape}, ps {ps.shape}, aps {aps.shape}, slot {slot}, "
                         f"lim {lim}")
    sc._check(*fields)
    _launch("mg_coarse_gcr_dir", coarse_gcr_dir, r.re, r.re.data_ptr(), r.im.data_ptr(),
            az.re.data_ptr(), az.im.data_ptr(), ps.re.data_ptr(), ps.im.data_ptr(),
            aps.re.data_ptr(), aps.im.data_ptr(), sc.vals.data_ptr(), sc.it.data_ptr(),
            sc.partials.data_ptr(), sc.ticket.data_ptr(), r.re.numel(), sc.S, lim, slot,
            int(clear), sc.tol2, sc.max_iter)


coarse_gcr_dir.launches = 0


def coarse_gcr_update_plain(x, r, ps, aps, slot: int, sc: CycleScalars) -> None:
    """Plain PyTorch version of :func:`coarse_gcr_update`."""
    alpha = sc.alpha
    xn = x + ps[slot] * alpha
    rn = r - aps[slot] * alpha
    for out, new in ((x.re, xn.re), (x.im, xn.im), (r.re, rn.re), (r.im, rn.im)):
        out.copy_(new)
    active = (sc.active > 0) & (sc.it < sc.max_iter)  # active implies it < max_iter
    sc.it.add_(active.to(sc.it.dtype))
    sc.r2.copy_(torch.where(active, cplx.abs2_sum(r), sc.r2))
    rel = torch.sqrt(sc.r2 / torch.clamp(sc.rhs_norm2, min=_tiny(sc.r2.dtype)))
    idx = sc.it.reshape(1)
    sc.hist.index_put_((idx,), torch.where(active, rel, sc.hist.index_select(0, idx)))
    sc.going.copy_(sc.running())


def coarse_gcr_update(x, r, ps, aps, slot: int, sc: CycleScalars) -> None:
    """x += alpha ps[slot] and r -= alpha aps[slot] (in place); where
    active, it += 1, r2 = ||r||^2 and hist[it] = sqrt(r2 / rhs_norm2); then
    ``going``: not converged and under max_iter."""
    fields = (x.re, x.im, r.re, r.im, ps.re, ps.im, aps.re, aps.im)
    if not _lib.on_cuda(*fields, sc.vals):
        return coarse_gcr_update_plain(x, r, ps, aps, slot, sc)
    if r.shape != x.shape or ps.shape != (sc.S,) + x.shape or aps.shape != ps.shape \
            or not 0 <= slot < sc.S:
        raise ValueError(f"shapes x {x.shape}, r {r.shape}, ps {ps.shape}, slot {slot}")
    sc._check(*fields)
    _launch("mg_coarse_gcr_update", coarse_gcr_update, x.re, x.re.data_ptr(), x.im.data_ptr(),
            r.re.data_ptr(), r.im.data_ptr(), ps.re.data_ptr(), ps.im.data_ptr(),
            aps.re.data_ptr(), aps.im.data_ptr(), sc.vals.data_ptr(), sc.hist.data_ptr(),
            sc.it.data_ptr(), sc.going.data_ptr(), sc.partials.data_ptr(),
            sc.ticket.data_ptr(), x.re.numel(), sc.S, slot, sc.tol2, sc.max_iter)


coarse_gcr_update.launches = 0
