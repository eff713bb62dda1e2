"""B12: the block-stencil SpMV's wrapper and its plain version.

``stencil_spmv`` replaces ``mgpgcr_tpu/ops/pallas/spmv.py::stencil_spmv``
(``_stencil_spmv_kernel``); the kernel is ``csrc/spmv.cu``, which says what
bounds it on an H100 and how. The blocks keep the Pallas wrapper's
``(nb, K, ne, ne)`` layout, K = 2 * ndim + 1, slot order ``[self, +d0, -d0,
+d1, -d1, ...]``; that wrapper's lane-major relayout and padded x are VMEM
artefacts with no counterpart here.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels import _lib


def _strides(dims: tuple[int, ...]) -> list[int]:
    """Row-major flat-index strides (dim 0 outermost)."""
    s = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        s[i] = s[i + 1] * dims[i + 1]
    return s


def stencil_neighbor_table(dims: tuple[int, ...]) -> np.ndarray:
    """(nb, 2*ndim+1) int32 table [self, +d0, -d0, +d1, -d1, ...], periodic;
    the slot convention of ``BlockMap.neighbor_table``. Counterpart of
    ``mgpgcr_tpu/ops/blockstencil.py::stencil_neighbor_table``."""
    nd = len(dims)
    nb = math.prod(dims)
    grids = np.indices(dims).reshape(nd, nb)
    strides = np.asarray(_strides(dims))[:, None]
    table = np.empty((nb, 2 * nd + 1), dtype=np.int32)
    table[:, 0] = np.arange(nb)
    for d in range(nd):
        for j, sgn in ((1 + 2 * d, +1), (2 + 2 * d, -1)):
            coords = grids.copy()
            coords[d] = (coords[d] + sgn) % dims[d]
            table[:, j] = (coords * strides).sum(axis=0)
    return table


@functools.lru_cache(maxsize=16)
def _table(dims: tuple[int, ...]) -> np.ndarray:
    return stencil_neighbor_table(dims)


def stencil_spmv_plain(blocks: cplx.CF, x: cplx.CF, dims) -> cplx.CF:
    """Plain PyTorch version of B12; see :func:`stencil_spmv`. The 2*ndim
    neighbour rows of x are gathered through the neighbour table, then each
    slot's blocks multiply and add; arithmetic in x's dtype (bf16 blocks are
    widened before they multiply). x may carry leading batch dims."""
    dims = tuple(int(d) for d in dims)
    nb, ne = math.prod(dims), blocks.shape[-1]
    b = blocks.astype(x.dtype)
    table = torch.as_tensor(_table(dims), dtype=torch.long, device=x.device)
    lead = tuple(x.shape[:-1])
    xr = x.re.reshape(lead + (nb, ne))[..., table, :]  # (..., nb, K, ne)
    xi = x.im.reshape(lead + (nb, ne))[..., table, :]
    yr = torch.zeros(lead + (nb, ne), dtype=x.dtype, device=x.device)
    yi = torch.zeros_like(yr)
    for k in range(table.shape[1]):
        br, bi = b.re[:, k], b.im[:, k]
        gr, gi = xr[..., k, :], xi[..., k, :]
        yr = yr + torch.einsum("rij,...rj->...ri", br, gr) - torch.einsum("rij,...rj->...ri", bi, gi)
        yi = yi + torch.einsum("rij,...rj->...ri", br, gi) + torch.einsum("rij,...rj->...ri", bi, gr)
    return cplx.CF(yr.reshape(lead + (nb * ne,)), yi.reshape(lead + (nb * ne,)))


def stencil_spmv(blocks: cplx.CF, x: cplx.CF, dims) -> cplx.CF:
    """y = A x for the periodic block stencil A over ``dims`` (1 to 4 dims).

    blocks: CF (nb, K, ne, ne), K = 2 * len(dims) + 1, f32 or bf16 on the
    card; x: CF (nb * ne,), f32 on the card; returns a new (nb * ne,) CF.
    CPU tensors take :func:`stencil_spmv_plain`; CUDA tensors launch the
    kernel or raise."""
    dims = tuple(int(d) for d in dims)
    if not _lib.on_cuda(blocks.re, blocks.im, x.re, x.im):
        return stencil_spmv_plain(blocks, x, dims)
    nb, nd = math.prod(dims), len(dims)
    ne = blocks.shape[-1]
    if not 1 <= nd <= 4 or blocks.shape != (nb, 2 * nd + 1, ne, ne) or x.shape != (nb * ne,):
        raise ValueError(f"shapes blocks {blocks.shape}, x {x.shape} do not fit dims {dims}")
    _lib.check_cuda(blocks.re, blocks.im, dtypes=(blocks.dtype,))
    _lib.check_cuda(blocks.re, dtypes=(torch.float32, torch.bfloat16))
    _lib.check_cuda(x.re, x.im)
    y = cplx.CF(torch.empty_like(x.re), torch.empty_like(x.im))
    d4 = dims + (1,) * (4 - nd)
    with torch.cuda.device(x.device):
        _lib.launch(
            "mg_stencil_spmv", blocks.re.data_ptr(), blocks.im.data_ptr(), x.re.data_ptr(),
            x.im.data_ptr(), y.re.data_ptr(), y.im.data_ptr(), nb, 2 * nd + 1, ne, nd, *d4,
            int(blocks.dtype == torch.bfloat16), _lib.stream(x.re),
        )
    _lib.count(stencil_spmv)
    return y


stencil_spmv.launches = 0
