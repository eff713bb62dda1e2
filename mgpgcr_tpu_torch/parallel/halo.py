"""One-site periodic halo exchange for domain-decomposed stencils.

Counterpart of ``mgpgcr_tpu/parallel/halo.py``. On a lattice axis split
over the ranks of a grid axis, a periodic nearest-neighbour shift is a
local shift whose wrapped-around face must come from the neighbouring
rank: slice off the face, receive the neighbour's through the
communicator, and join it to the surviving interior. Unsplit axes are
``torch.roll``.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx


def periodic_shift(x, axis: int, shift: int, comm=None, axis_name: str | None = None,
                   width: int = 1):
    """Periodic shift of a (possibly split) axis of ``x`` (a tensor or CF)
    by one site.

    ``shift=-1`` brings the value at site i+1 to slot i (forward neighbour
    psi(x+mu)); ``shift=+1`` brings site i-1 to slot i (backward). With
    ``comm`` and an ``axis_name`` of more than one rank, ``x`` is this
    rank's shard and the face is exchanged with the ring neighbour; every
    rank must make the same call. ``width`` is the element count of one
    site along the axis (X for y on a merged Y*X axis)."""
    if shift not in (-1, 1):
        raise ValueError("halo exchange supports single-site shifts only")
    if comm is None or comm.axis_size(axis_name) == 1:
        if cplx.is_cf(x):
            return cplx.roll(x, shift * width, axis)
        return torch.roll(x, shift * width, axis)
    axis = axis % x.ndim
    extent = x.shape[axis]

    def part(lo, hi):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(lo, hi)
        return x[tuple(idx)]

    cat = cplx.concatenate if cplx.is_cf(x) else (lambda xs, axis: torch.cat(xs, dim=axis))
    if shift == -1:
        # slot i <- site i+1: the last face comes from the next rank's first
        recv = comm.recv_from_next(part(0, width), axis_name)
        return cat([part(width, extent), recv], axis=axis)
    recv = comm.recv_from_prev(part(extent - width, extent), axis_name)
    return cat([recv, part(0, extent - width)], axis=axis)
