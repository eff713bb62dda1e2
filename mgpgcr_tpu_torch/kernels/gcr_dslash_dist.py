"""B15: the ghost-plane one-pass GCR step on one shard of a (t, z)-split
lattice, its wrapper, its plain version, and the host side that forms and
receives the ghosts.

``gcr_stream_step_local`` replaces
``mgpgcr_tpu/ops/pallas/gcr_dslash_dist.py::gcr_stream_step_local``
(``_gcr_step_dist_kernel``). The kernel is K2's (``csrc/gcr_dslash.cu``,
``mg_gcr_stream_step_dist``) with the halo policy of B14. The stencil runs
on the updated residual r' = r - alpha aps[lim-1], which exists nowhere
before the step, so each rank forms r' on its own faces (a one-plane
axpy), the ranks exchange those and sign them as B14's psi ghosts, and the
kernel reads them as they are: its r' recomputation applies to interior
neighbours only. The three reductions are this shard's partials; the
solver sums them over ranks.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib
from mgpgcr_tpu_torch.kernels.dslash_dist import (
    Ghosts,
    _check_ghosts,
    dslash_dist_plain,
    exchange_ghosts,
    field_face,
    halo_table,
)
from mgpgcr_tpu_torch.kernels.gcr_dslash import _check_step, _dots_plain, _split_res, _step_outputs


def step_ghosts(r, aps, alpha, lim: int, comm, axis_t, axis_z, anti_t: bool,
                ghost_links) -> Ghosts:
    """The r' = r - alpha aps[lim-1] ghosts of this rank's step, formed on
    its faces and exchanged (:func:`exchange_ghosts`)."""
    ap = aps[lim - 1]

    def face(dim, i):
        return field_face(r, dim, i) - field_face(ap, dim, i) * alpha

    return exchange_ghosts(face, comm, axis_t, axis_z, anti_t, ghost_links)


def gcr_stream_step_dist_plain(links, r, aps, alpha, k, lim: int, mesh, ghosts: Ghosts):
    """Plain PyTorch version of B15; see :func:`gcr_stream_step_dist`."""
    rp = r - aps[lim - 1] * alpha
    az = dslash_dist_plain(links, rp, mesh, ghosts, k)
    return (rp, az, cplx.abs2_sum(rp), *_dots_plain(aps, lim, az, rp))


def gcr_stream_step_dist(links, r, aps, alpha, k, lim: int, mesh, ghosts: Ghosts):
    """(r', az, ||r'||^2, raw, apr) of one unpreconditioned GCR iteration
    on one shard, as ``gcr_stream_step`` computes them on a whole lattice,
    with the stencil's neighbours past the shard's edges read from
    ``ghosts`` (already r', already signed) and the reductions this shard's
    partials. Shapes as in ``gcr_stream_step`` with ``mesh`` the shard's
    extents. CPU tensors take :func:`gcr_stream_step_dist_plain`; CUDA
    tensors launch B15 or raise."""
    tensors = [links.re, links.im, r.re, r.im, aps.re, aps.im, alpha, k, *ghosts.tensors()]
    if not _lib.on_cuda(*tensors):
        return gcr_stream_step_dist_plain(links, r, aps, alpha, k, lim, mesh, ghosts)
    _check_step(links, [r], aps, lim, mesh, [alpha, k])
    _check_ghosts(links, mesh, ghosts)
    t, z, y, xx = mesh.spacetime_dims
    s_rows = aps.shape[0]
    rp = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    az = cplx.CF(torch.empty_like(r.re), torch.empty_like(r.im))
    partials, res = _step_outputs(mesh, s_rows, r.device)
    ab, kb = _lib.pairs(alpha), _lib.pairs(k)
    with torch.cuda.device(r.device):
        _lib.launch(
            "mg_gcr_stream_step_dist", r.re.data_ptr(), r.im.data_ptr(), aps.re.data_ptr(),
            aps.im.data_ptr(), links.re.data_ptr(), links.im.data_ptr(),
            ab.data_ptr(), kb.data_ptr(),
            rp.re.data_ptr(), rp.im.data_ptr(), az.re.data_ptr(), az.im.data_ptr(),
            partials.data_ptr(), res.data_ptr(), s_rows, lim, t, z, y, xx, links.shape[2],
            int(links.dtype == torch.bfloat16), halo_table(ghosts), _lib.stream(r.re),
        )
    _lib.count(gcr_stream_step_dist)
    return (rp, az, res[4 * s_rows + 2], *_split_res(res, s_rows))


gcr_stream_step_dist.launches = 0


def gcr_stream_step_local(links, ghost_links, r, aps, alpha, k, lim: int, local_mesh, comm,
                          axis_t="t", axis_z=None, anti_t: bool = False):
    """Per-rank (r', az, ||r'||^2, raw, apr): form and exchange the r'
    ghosts, then run B15. The three reductions are LOCAL partials: sum them
    over ranks (``comm.allsum``). Every rank must call this together."""
    g = step_ghosts(r, aps, alpha, lim, comm, axis_t, axis_z, anti_t, ghost_links)
    return gcr_stream_step_dist(links, r, aps, alpha, k, lim, local_mesh, g)
