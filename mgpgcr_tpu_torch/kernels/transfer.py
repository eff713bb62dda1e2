"""B10 and B11: the MG grid transfers' wrappers and plain versions.

``restrict`` replaces ``mgpgcr_tpu/ops/pallas/transfer.py::restrict_pallas``
(``_restrict_kernel``) and ``prolong`` replaces ``::prolong_pallas``
(``_prolong_kernel``); the kernels are ``csrc/transfer.cu``. The plain
versions are the JAX package's field-shaped forms
(``mgpgcr_tpu/solvers/mg.py::restrict_field`` / ``prolong_field``): a
spin-colour contraction and block sums or broadcasts by pure reshapes.
The basis ``q_field`` is ``(ne, 4, 3, T, Z, Y*X)``, stored f32 or bf16;
coarse vectors are flat ``(nb * ne,)``, b-major and e-minor.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib
from mgpgcr_tpu_torch.mesh import BlockMap

_THREADS = 256  # csrc/common.cuh kThreads
_MAX_ROW = 6144  # csrc/transfer.cu: restrict's row buffer holds Y*X sites


def _split(block_map: BlockMap) -> tuple[int, ...]:
    """(Bt, bt, Bz, bz, By, by, Bx, bx)."""
    out = ()
    for nbd, b in zip(block_map.blocks_per_dim, block_map.block_dims):
        out += (nbd, b)
    return out


def restrict_plain(q_field, block_map: BlockMap, x):
    """Plain PyTorch version of B10; see :func:`restrict`. Arithmetic in
    x's dtype."""
    ne = q_field.shape[0]
    q = q_field.astype(x.dtype)
    sites = tuple(x.shape[2:])
    qr, qi = q.re.reshape((ne, 12) + sites), q.im.reshape((ne, 12) + sites)
    xr, xi = x.re.reshape((12,) + sites), x.im.reshape((12,) + sites)
    pr = (qr * xr + qi * xi).sum(1)  # (ne, T, Z, V)
    pi = (qr * xi - qi * xr).sum(1)
    shape = (ne,) + _split(block_map)
    nb = block_map.n_blocks
    re = pr.reshape(shape).sum((2, 4, 6, 8)).reshape(ne, nb).T
    im = pi.reshape(shape).sum((2, 4, 6, 8)).reshape(ne, nb).T
    return cplx.CF(re.reshape(nb * ne), im.reshape(nb * ne))


def restrict(q_field, block_map: BlockMap, x):
    """R x = P^H x: a slab field (4, 3, T, Z, Y*X) -> the coarse (nb*ne,)
    CF, b-major / e-minor. CPU tensors take :func:`restrict_plain`; CUDA
    tensors launch the kernel or raise (f32 x, f32 or bf16 basis)."""
    tensors = [q_field.re, q_field.im, x.re, x.im]
    if not _lib.on_cuda(*tensors):
        return restrict_plain(q_field, block_map, x)
    t, z, y, xx = block_map.mesh.spacetime_dims
    ne = q_field.shape[0]
    if x.shape != (4, 3, t, z, y * xx) or q_field.shape != (ne,) + x.shape:
        raise ValueError(f"shapes q_field {q_field.shape}, x {x.shape} do not fit {block_map}")
    if y * xx > _MAX_ROW:
        raise ValueError(f"restrict kernel holds at most {_MAX_ROW} sites of a (t, z) row")
    _lib.check_cuda(q_field.re, q_field.im, dtypes=(torch.float32, torch.bfloat16))
    _lib.check_cuda(x.re, x.im)
    dev = x.device
    bt, bz, by, bx = block_map.block_dims
    nb = block_map.n_blocks
    partials = torch.empty(2 * ne * t * (nb // (t // bt)), dtype=torch.float64, device=dev)
    out = cplx.CF(torch.empty(nb * ne, dtype=torch.float32, device=dev),
                  torch.empty(nb * ne, dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_restrict", q_field.re.data_ptr(), q_field.im.data_ptr(), x.re.data_ptr(),
            x.im.data_ptr(), partials.data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
            ne, t, z, y, xx, bt, bz, by, bx, int(q_field.dtype == torch.bfloat16),
            _lib.stream(x.re),
        )
    _lib.count(restrict)
    return out


restrict.launches = 0


def prolong_plain(q_field, block_map: BlockMap, xc, r=None, damping: float = 1.0):
    """Plain PyTorch version of B11; see :func:`prolong`. Arithmetic in
    xc's dtype."""
    ne = q_field.shape[0]
    nb = block_map.n_blocks
    split = _split(block_map)
    q = q_field.astype(xc.dtype)
    sites = tuple(q.shape[3:])

    def bcast(c):  # (nb * ne,) -> (ne, 1, 1, T, Z, V), constant over each block
        cb = c.reshape(nb, ne).T.reshape((ne,) + split[0::2])
        cb = cb.reshape((ne, split[0], 1, split[2], 1, split[4], 1, split[6], 1))
        return cb.expand((ne,) + split).reshape((ne, 1, 1) + sites)

    cr, ci = bcast(xc.re), bcast(xc.im)
    out = cplx.CF((q.re * cr - q.im * ci).sum(0), (q.re * ci + q.im * cr).sum(0))
    if damping != 1.0:
        out = cplx.scale_real(out, damping)
    return out if r is None else r + out


def prolong(q_field, block_map: BlockMap, xc, r=None, damping: float = 1.0):
    """(r if given else 0) + damping * P xc: the coarse (nb*ne,) CF -> a
    slab field, with the additive base and the damping in the same pass.
    CPU tensors take :func:`prolong_plain`; CUDA tensors launch the kernel
    or raise (f32 xc and r, f32 or bf16 basis)."""
    tensors = [q_field.re, q_field.im, xc.re, xc.im] + ([] if r is None else [r.re, r.im])
    if not _lib.on_cuda(*tensors):
        return prolong_plain(q_field, block_map, xc, r, damping)
    t, z, y, xx = block_map.mesh.spacetime_dims
    ne = q_field.shape[0]
    nb = block_map.n_blocks
    fshape = (4, 3, t, z, y * xx)
    if q_field.shape != (ne,) + fshape or xc.shape != (nb * ne,) or (
        r is not None and r.shape != fshape
    ):
        raise ValueError(f"shapes q_field {q_field.shape}, xc {xc.shape} do not fit {block_map}")
    _lib.check_cuda(q_field.re, q_field.im, dtypes=(torch.float32, torch.bfloat16))
    _lib.check_cuda(xc.re, xc.im)
    if r is not None:
        _lib.check_cuda(r.re, r.im)
    dev = xc.device
    bt, bz, by, bx = block_map.block_dims
    out = cplx.CF(torch.empty(fshape, dtype=torch.float32, device=dev),
                  torch.empty(fshape, dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        _lib.launch(
            "mg_prolong", q_field.re.data_ptr(), q_field.im.data_ptr(), xc.re.data_ptr(),
            xc.im.data_ptr(), None if r is None else r.re.data_ptr(),
            None if r is None else r.im.data_ptr(), out.re.data_ptr(), out.im.data_ptr(),
            float(damping), ne, t, z, y, xx, bt, bz, by, bx,
            int(q_field.dtype == torch.bfloat16), _lib.stream(xc.re),
        )
    _lib.count(prolong)
    return out


prolong.launches = 0
