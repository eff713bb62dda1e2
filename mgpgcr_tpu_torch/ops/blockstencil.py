"""Stencil-structured block-sparse operator: the coarse-grid format of
large MG hierarchies and the compute format of ingested lattice matrices.

Counterpart of ``mgpgcr_tpu/ops/blockstencil.py``. The Galerkin coarse
operators (MG.h:229-276), and the ingested Dirac matrices, are uniform
block stencils: ``nb`` block rows of ``ne x ne`` blocks, each row coupling
only to itself and its 2 * ndim periodic grid neighbours,

    y[r] = B_self[r] x[r] + sum_mu B_{+mu}[r] x[r + mu] + B_{-mu}[r] x[r - mu].

``StencilBlockOperator.apply`` runs the block-stencil SpMV kernel B12 for
CUDA tensors and its plain version for CPU tensors
(``kernels/spmv.py``); there is one route, as with the transfers.
``detect_block_stencil`` checks a CSR matrix against the structure and
extracts the block tensor (numpy, as in the JAX package); ``from_csr``
builds the operator from an ingested CSR matrix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels.spmv import stencil_neighbor_table, stencil_spmv
from mgpgcr_tpu_torch.ops.base import LinearOperator

__all__ = ["StencilBlockOperator", "detect_block_stencil", "stencil_neighbor_table"]


def detect_block_stencil(csr, dims: tuple[int, ...], ne: int) -> np.ndarray | None:
    """The (nb, 2*ndim+1, ne, ne) complex block tensor of ``csr`` (any
    object with ``shape``, ``indptr``, ``indices`` and ``data``) when it is
    an ``ne``-blocked periodic nearest-neighbour stencil on the ``dims``
    grid, else None. Couplings on short dims (extent <= 2, where +mu and
    -mu coincide) go to the first matching slot."""
    n = csr.shape[0]
    nb = math.prod(dims)
    if csr.shape[0] != csr.shape[1] or n != nb * ne:
        return None
    indptr = np.asarray(csr.indptr)
    cols = np.asarray(csr.indices)
    vals = np.asarray(csr.data)
    table = stencil_neighbor_table(dims)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    br, ri = rows // ne, rows % ne
    bc, ci = cols // ne, cols % ne
    match = table[br] == bc[:, None]  # (nnz, K)
    if not match.any(axis=1).all():
        return None  # a coupling outside the stencil
    slot = match.argmax(axis=1)
    blocks = np.zeros((nb, table.shape[1], ne, ne), dtype=np.complex128)
    np.add.at(blocks, (br, slot, ri, ci), vals)
    return blocks


@dataclasses.dataclass(frozen=True)
class StencilBlockOperator(LinearOperator):
    """Uniform block-stencil operator. ``blocks``: (nb, 2*ndim+1, ne, ne)
    split re/im CF (a complex tensor is split), slot order [self, +d0, -d0,
    ...], block rows row-major over ``dims``; stored f32, bf16 or f64,
    arithmetic in the field's dtype. Fields are flat (nb*ne,) CFs."""

    blocks: cplx.CF
    dims: tuple[int, ...]

    def __post_init__(self):
        b = self.blocks
        if not cplx.is_cf(b):
            b = cplx.CF(b.real.contiguous(), b.imag.contiguous())
        object.__setattr__(self, "blocks", b)
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))

    @property
    def ne(self) -> int:
        return self.blocks.shape[-1]

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        n = self.n_blocks * self.ne
        return (n, n)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def dtype(self) -> torch.dtype:
        """The real dtype of the fields it applies to."""
        return torch.float64 if self.blocks.dtype == torch.float64 else torch.float32

    @staticmethod
    def from_csr(csr, dims: tuple[int, ...], ne: int, dtype=torch.float32,
                 device=None) -> "StencilBlockOperator | None":
        """Detect and build from an ingested CSR matrix (``ops/csr.py``), the
        blocks stored as ``dtype`` on ``device`` (CUDA unless named); None
        when the matrix is not an ``ne``-blocked stencil on ``dims``."""
        blocks = detect_block_stencil(csr, dims, ne)
        if blocks is None:
            return None
        return StencilBlockOperator(cplx.from_numpy(blocks, dtype, device), dims)

    def with_block_dtype(self, dtype) -> "StencilBlockOperator":
        """Reduced-precision block storage (e.g. ``torch.bfloat16``): the
        SpMV is bound by the bytes of the blocks."""
        return StencilBlockOperator(self.blocks.astype(dtype), self.dims)

    def apply(self, x):
        """A x through B12 (the plain version for CPU tensors); x is a CF,
        or a complex tensor, which is split and joined again."""
        if cplx.is_cf(x):
            return stencil_spmv(self.blocks, x, self.dims)
        y = stencil_spmv(self.blocks, cplx.ascf(x), self.dims)
        return torch.complex(y.re, y.im)

    def _apply_xla(self, x: cplx.CF) -> cplx.CF:
        """The JAX package's XLA form, a second plain version: per direction
        a periodic roll of the gridded x and a batched block product,
        arithmetic in x's dtype (blocks widened first); x may carry leading
        batch dims."""
        nd, nb, ne = len(self.dims), self.n_blocks, self.ne
        lead = tuple(x.shape[:-1])
        xg = x.reshape(lead + self.dims + (ne,))
        b = self.blocks.astype(x.dtype)
        bg = b.reshape(self.dims + tuple(b.shape[1:]))
        sub = "".join(chr(ord("a") + i) for i in range(nd))
        eq = f"{sub}ij,...{sub}j->...{sub}i"

        def prod(k, v):
            br, bi = bg.re[..., k, :, :], bg.im[..., k, :, :]
            return cplx.CF(torch.einsum(eq, br, v.re) - torch.einsum(eq, bi, v.im),
                           torch.einsum(eq, br, v.im) + torch.einsum(eq, bi, v.re))

        y = prod(0, xg)
        for d in range(nd):
            ax = len(lead) + d
            y = y + prod(1 + 2 * d, cplx.roll(xg, -1, ax))  # x at coord + 1
            y = y + prod(2 + 2 * d, cplx.roll(xg, 1, ax))
        return y.reshape(lead + (nb * ne,))
