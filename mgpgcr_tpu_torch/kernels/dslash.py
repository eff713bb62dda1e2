"""K1 and B13: the Dslash kernels' wrappers and their plain versions.

``dslash_apply`` replaces ``mgpgcr_tpu/ops/pallas/dslash.py::dslash_apply``
(streaming branch, ``_dslash_stream_kernel``) on t-major links;
``dslash_mu`` replaces its blocked branch (``_dslash_kernel``, taken when
tb > 1 or zb < Z) on mu-major links. Both kernels are ``csrc/dslash.cu``,
which says what bounds them on an H100 and how.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib
from mgpgcr_tpu_torch.ops.wilson_slab import slab_dslash


def reconstruct_su3(links_tmajor: cplx.CF, dtype=None) -> cplx.CF:
    """(T, 4, 2, 3, Z, V) two-row links -> (T, 4, 3, 3, Z, V) with
    row2 = conj(row0 x row1), computed in ``dtype`` (default: f32 for
    reduced-precision storage, else the storage dtype). Counterpart of
    ``_reconstruct_su3`` in ``mgpgcr_tpu/ops/pallas/dslash.py``."""
    if dtype is None:
        dtype = torch.float64 if links_tmajor.dtype == torch.float64 else torch.float32
    r = links_tmajor.astype(dtype)
    r0, r1 = r[:, :, 0], r[:, :, 1]
    row2 = cplx.stack(
        [
            (r0[:, :, b] * r1[:, :, c] - r0[:, :, c] * r1[:, :, b]).conj()
            for (b, c) in ((1, 2), (2, 0), (0, 1))
        ],
        axis=2,
    )
    return cplx.concatenate([r, cplx.CF(row2.re[:, :, None], row2.im[:, :, None])], axis=2)


def full_links(links: cplx.CF, dtype) -> cplx.CF:
    """t-major (T, 4, R, 3, Z, V) storage -> (T, 4, 3, 3, Z, V) in ``dtype``,
    rebuilding row 2 of two-row links."""
    if links.shape[2] == 2:
        return reconstruct_su3(links, dtype)
    return links.astype(dtype)


def dslash_plain(links, psi, mesh, k=None, anti_t: bool = False) -> cplx.CF:
    """Plain PyTorch version of K1: D psi, or psi - k D psi with a complex
    0-d ``k``; t-major links with 3 or 2 rows in any storage dtype,
    arithmetic in psi's dtype; ``anti_t`` negates the hops that cross the
    t boundary (here by flipping U_t on the last t-plane, which is the
    same operator)."""
    u = full_links(links, psi.dtype).permute(1, 2, 3, 0, 4, 5)  # mu-major
    if anti_t:
        u = cplx.CF(u.re.clone(), u.im.clone())
        u.re[0, :, :, -1] *= -1
        u.im[0, :, :, -1] *= -1
    d = slab_dslash(u, psi, mesh.spacetime_dims[3])
    return d if k is None else psi - d * k


def dslash_apply(links, psi, mesh, k=None, anti_t: bool = False) -> cplx.CF:
    """D psi (or psi - k D psi) on slab fields (4, 3, T, Z, Y*X).

    links: t-major (T, 4, R, 3, Z, Y*X) CF, R = 3 or 2, f32 or bf16 on the
    card; psi: f32 CF; k: complex 0-d tensor or None. CPU tensors take
    :func:`dslash_plain`; CUDA tensors launch the kernel or raise."""
    tensors = [links.re, links.im, psi.re, psi.im] + ([k] if k is not None else [])
    if not _lib.on_cuda(*tensors):
        return dslash_plain(links, psi, mesh, k, anti_t)
    t, z, y, xx = mesh.spacetime_dims
    if psi.shape != (4, 3, t, z, y * xx) or links.shape[0] != t or links.shape[2] not in (2, 3):
        raise ValueError(f"shapes links {links.shape}, psi {psi.shape} do not fit {mesh.dims}")
    _lib.check_cuda(psi.re, psi.im)
    _lib.check_cuda(links.re, links.im, dtypes=(torch.float32, torch.bfloat16))
    kk = None if k is None else _lib.pairs(k.to(torch.complex64).reshape(()))
    out = cplx.CF(torch.empty_like(psi.re), torch.empty_like(psi.im))
    with torch.cuda.device(psi.device):
        _lib.launch(
            "mg_dslash", psi.re.data_ptr(), psi.im.data_ptr(), links.re.data_ptr(),
            links.im.data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
            None if kk is None else kk.data_ptr(),
            t, z, y, xx, links.shape[2], int(links.dtype == torch.bfloat16), int(anti_t),
            _lib.stream(psi.re),
        )
    _lib.count(dslash_apply)
    return out


dslash_apply.launches = 0


def dslash_mu_plain(links, psi, mesh, k=None) -> cplx.CF:
    """Plain PyTorch version of B13: D psi, or psi - k D psi with a complex
    0-d ``k``, on mu-major (4, 3, 3, T, Z, Y*X) links in any storage dtype
    (any boundary sign already folded into them), arithmetic in psi's
    dtype."""
    d = slab_dslash(links.astype(psi.dtype), psi, mesh.spacetime_dims[3])
    return d if k is None else psi - d * k


def dslash_mu(links, psi, mesh, k=None) -> cplx.CF:
    """D psi (or psi - k D psi) on slab fields (4, 3, T, Z, Y*X) with
    mu-major links (4, 3, 3, T, Z, Y*X), 3 rows, f32 or bf16 on the card.
    CPU tensors take :func:`dslash_mu_plain`; CUDA tensors launch the
    kernel or raise."""
    tensors = [links.re, links.im, psi.re, psi.im] + ([k] if k is not None else [])
    if not _lib.on_cuda(*tensors):
        return dslash_mu_plain(links, psi, mesh, k)
    t, z, y, xx = mesh.spacetime_dims
    fshape = (4, 3, t, z, y * xx)
    if psi.shape != fshape or links.shape != (4, 3, 3) + fshape[2:]:
        raise ValueError(f"shapes links {links.shape}, psi {psi.shape} do not fit {mesh.dims}")
    _lib.check_cuda(psi.re, psi.im)
    _lib.check_cuda(links.re, links.im, dtypes=(torch.float32, torch.bfloat16))
    kk = None if k is None else _lib.pairs(k.to(torch.complex64).reshape(()))
    out = cplx.CF(torch.empty_like(psi.re), torch.empty_like(psi.im))
    with torch.cuda.device(psi.device):
        _lib.launch(
            "mg_dslash_mu", psi.re.data_ptr(), psi.im.data_ptr(), links.re.data_ptr(),
            links.im.data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
            None if kk is None else kk.data_ptr(), t, z, y, xx,
            int(links.dtype == torch.bfloat16), _lib.stream(psi.re),
        )
    _lib.count(dslash_mu)
    return out


dslash_mu.launches = 0
