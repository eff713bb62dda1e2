"""B14: the ghost-plane Dslash on one shard of a (t, z)-split lattice, its
wrapper, its plain version, and the host side that receives the ghosts.

``dslash_apply_local`` replaces
``mgpgcr_tpu/ops/pallas/dslash_dist.py::dslash_apply_local``
(``_dslash_stream_dist_kernel``). The kernel is K1's (``csrc/dslash.cu``,
``mg_dslash_dist``) with a halo policy: a neighbour across the shard's t
edge, or its z edge when z is split over ranks, is read from a ghost plane
instead of the wrapped plane. The psi ghosts come from the neighbouring
ranks through the communicator on every call, the anti-periodic sign
folded into them on the ranks at the global t edge; the link ghosts (the
t-previous rank's U_t plane, the z-previous rank's U_z column) are
constant over a solve and cut from the global links at build
(``ops/dslash_dist.py``), where the JAX package exchanges them per call
with the same result.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib
from mgpgcr_tpu_torch.kernels.dslash import full_links
from mgpgcr_tpu_torch.ops.wilson_slab import slab_dslash


@dataclasses.dataclass(frozen=True)
class Ghosts:
    """The neighbours' planes one shard's stencil reads past its edges."""

    tp: cplx.CF  # (4, 3, 1, Z, V): psi at t = T, the boundary sign applied
    tm: cplx.CF  # (4, 3, 1, Z, V): psi at t = -1, the boundary sign applied
    ut: cplx.CF  # (1, 1, R, 3, Z, V): U_t at t = -1, stored form
    zp: cplx.CF | None = None  # (4, 3, T, 1, V): psi at z = Z, when z is split
    zm: cplx.CF | None = None  # (4, 3, T, 1, V): psi at z = -1
    uz: cplx.CF | None = None  # (T, 1, R, 3, 1, V): U_z at z = -1

    def tensors(self) -> list:
        return [p for f in (self.tp, self.tm, self.ut, self.zp, self.zm, self.uz)
                if f is not None for p in (f.re, f.im)]


def exchange_ghosts(face, comm, axis_t, axis_z, anti_t: bool, ghost_links) -> Ghosts:
    """The ghosts of this rank's stencil input, ``face(dim, i)`` being its
    own face at index i (0 or -1) of field dim 2 (t) or 3 (z). Every rank
    must call this together. With one rank along t the t ghosts are the
    shard's own wrap planes; under ``anti_t`` the planes that cross the
    global t edge are negated (the last t rank's ``tp``, the first's
    ``tm``). ``ghost_links`` is the (U_t plane, U_z column) pair of
    :class:`Ghosts`; the column is None when z is not split."""
    nt, nz = comm.axis_size(axis_t), comm.axis_size(axis_z)
    items = [(face(2, 0), axis_t, 1), (face(2, -1), axis_t, -1)] if nt > 1 else []
    if nz > 1:
        items += [(face(3, 0), axis_z, 1), (face(3, -1), axis_z, -1)]
    got = comm.exchange(items) if items else []  # all faces in one round
    if nt > 1:
        tp, tm = got[0], got[1]
        it = comm.axis_index(axis_t)
        sign_p = -1 if anti_t and it == nt - 1 else 1
        sign_m = -1 if anti_t and it == 0 else 1
    else:  # one rank along t: the shard's own wrap planes
        tp, tm = face(2, 0), face(2, -1)
        sign_p = sign_m = -1 if anti_t else 1
    tp = (-tp if sign_p < 0 else tp).contiguous()
    tm = (-tm if sign_m < 0 else tm).contiguous()
    zp, zm = (got[-2].contiguous(), got[-1].contiguous()) if nz > 1 else (None, None)
    ut, uz = ghost_links
    return Ghosts(tp, tm, ut, zp, zm, uz)


def field_face(x: cplx.CF, dim: int, i: int) -> cplx.CF:
    """The one-site face of ``x`` at index i (0 or -1) of ``dim``."""
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(0, 1) if i == 0 else slice(x.shape[dim] - 1, None)
    return x[tuple(idx)]


def psi_ghosts(psi, comm, axis_t, axis_z, anti_t: bool, ghost_links) -> Ghosts:
    """:func:`exchange_ghosts` of a stencil input ``psi``."""
    return exchange_ghosts(lambda d, i: field_face(psi, d, i), comm, axis_t, axis_z, anti_t,
                           ghost_links)


def _zeros(shape, like: cplx.CF) -> cplx.CF:
    return cplx.CF(torch.zeros(shape, dtype=like.dtype, device=like.device),
                   torch.zeros(shape, dtype=like.dtype, device=like.device))


def dslash_dist_plain(links, psi, mesh, ghosts: Ghosts, k=None) -> cplx.CF:
    """Plain PyTorch version of B14: the ghosts spliced into a copy of psi
    and of the links padded by one site along t (and z, when z is split),
    ``dslash_plain``'s stencil on it with no wrap sign, the interior kept;
    arithmetic in psi's dtype."""
    t, z, y, xx = mesh.spacetime_dims
    v = y * xx
    zo = int(ghosts.zp is not None)
    zs = slice(zo, zo + z)
    pp = _zeros((4, 3, t + 2, z + 2 * zo, v), psi)
    pp[:, :, 1 : t + 1, zs] = psi
    pp[:, :, :1, zs] = ghosts.tm
    pp[:, :, t + 1 :, zs] = ghosts.tp
    uu = _zeros((t + 2, 4, 3, 3, z + 2 * zo, v), psi)
    uu[1 : t + 1, :, :, :, zs] = full_links(links, psi.dtype)
    uu[:1, :1, :, :, zs] = full_links(ghosts.ut, psi.dtype)
    if zo:
        pp[:, :, 1 : t + 1, :1] = ghosts.zm
        pp[:, :, 1 : t + 1, z + 1 :] = ghosts.zp
        uu[1 : t + 1, 1:2, :, :, :1] = full_links(ghosts.uz, psi.dtype)
    d = slab_dslash(uu.permute(1, 2, 3, 0, 4, 5), pp, xx)[:, :, 1 : t + 1, zs]
    return d if k is None else psi - d * k


def _check_ghosts(links, mesh, g: Ghosts) -> None:
    t, z, y, xx = mesh.spacetime_dims
    v, r = y * xx, links.shape[2]
    want = [(g.tp, (4, 3, 1, z, v)), (g.tm, (4, 3, 1, z, v)), (g.ut, (1, 1, r, 3, z, v))]
    if g.zp is not None:
        want += [(g.zp, (4, 3, t, 1, v)), (g.zm, (4, 3, t, 1, v)), (g.uz, (t, 1, r, 3, 1, v))]
    for f, shape in want:
        if f is None or f.shape != shape:
            raise ValueError(f"ghost of shape {None if f is None else f.shape}, want {shape}")
    _lib.check_cuda(g.tp.re, g.tp.im, g.tm.re, g.tm.im,
                    *([] if g.zp is None else [g.zp.re, g.zp.im, g.zm.re, g.zm.im]))
    lt = [g.ut.re, g.ut.im] + ([] if g.uz is None else [g.uz.re, g.uz.im])
    _lib.check_cuda(*lt, dtypes=(links.dtype,))


def halo_table(g: Ghosts):
    """The kernels' ghost table: 12 pointers in the order of common.cuh
    Halo, null for the z ghosts when z is not split. The caller keeps
    ``g`` alive across the launch."""
    fields = (g.tp, g.tm, g.ut, g.zp, g.zm, g.uz)
    ptrs = [None if f is None else p.data_ptr() for f in fields
            for p in ((None, None) if f is None else (f.re, f.im))]
    return (ctypes.c_void_p * 12)(*ptrs)


def dslash_dist(links, psi, mesh, ghosts: Ghosts, k=None) -> cplx.CF:
    """D psi (or psi - k D psi) on one shard (4, 3, T, Z, Y*X) with the
    neighbours' ghost planes. links: this shard's t-major (T, 4, R, 3, Z,
    Y*X) CF, R = 3 or 2, f32 or bf16 on the card; ``mesh`` the shard's
    extents. CPU tensors take :func:`dslash_dist_plain`; CUDA tensors
    launch B14 or raise."""
    tensors = [links.re, links.im, psi.re, psi.im, *ghosts.tensors()]
    if k is not None:
        tensors.append(k)
    if not _lib.on_cuda(*tensors):
        return dslash_dist_plain(links, psi, mesh, ghosts, k)
    t, z, y, xx = mesh.spacetime_dims
    if psi.shape != (4, 3, t, z, y * xx) or links.shape[0] != t or links.shape[2] not in (2, 3):
        raise ValueError(f"shapes links {links.shape}, psi {psi.shape} do not fit {mesh.dims}")
    _lib.check_cuda(psi.re, psi.im)
    _lib.check_cuda(links.re, links.im, dtypes=(torch.float32, torch.bfloat16))
    _check_ghosts(links, mesh, ghosts)
    kk = None if k is None else _lib.pairs(k.to(torch.complex64).reshape(()))
    out = cplx.CF(torch.empty_like(psi.re), torch.empty_like(psi.im))
    with torch.cuda.device(psi.device):
        _lib.launch(
            "mg_dslash_dist", psi.re.data_ptr(), psi.im.data_ptr(), links.re.data_ptr(),
            links.im.data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
            None if kk is None else kk.data_ptr(), t, z, y, xx, links.shape[2],
            int(links.dtype == torch.bfloat16), halo_table(ghosts), _lib.stream(psi.re),
        )
    _lib.count(dslash_dist)
    return out


dslash_dist.launches = 0


def dslash_apply_local(links, ghost_links, psi, local_mesh, comm, axis_t="t", axis_z=None,
                       k=None, anti_t: bool = False) -> cplx.CF:
    """Per-rank D psi (or A psi = psi - k D psi): receive psi's ghosts from
    the neighbouring ranks and run B14. Every rank must call this
    together. ``links`` and ``ghost_links`` are this rank's t-major slab
    and its (U_t plane, U_z column) ghosts, as in :func:`exchange_ghosts`."""
    g = psi_ghosts(psi, comm, axis_t, axis_z, anti_t, ghost_links)
    return dslash_dist(links, psi, local_mesh, g, k)

