"""Block-sparse operator (block-ELL layout): a coarse-grid format.

Counterpart of ``mgpgcr_tpu/ops/bsr.py`` (the reference's
``HierarchicalSparse<T, cT>``, HierarchicalSparse.h:22-199). The Galerkin
coarse operator has exactly K blocks per block row (self and the 2 * ndim
neighbours, MG.h:229-276), so the values are one dense ``(nb, K, ne, ne)``
complex tensor and the block column ids one ``(nb, K)`` index tensor. The
matvec is one batched ``einsum`` over the gathered block columns, as the
JAX package leaves it to XLA: it is no kernel of the port. Duplicate
(row, col) blocks simply add (HierarchicalSparse.h:20-21, quirk Q10).
"""

from __future__ import annotations

import dataclasses

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.ops.base import LinearOperator


@dataclasses.dataclass(frozen=True)
class BlockSparseOperator(LinearOperator):
    blocks: torch.Tensor  # (nb, K, ne, ne) complex (a CF is converted)
    block_cols: torch.Tensor  # (nb, K) block column ids (an ndarray is converted)

    def __post_init__(self):
        b = self.blocks
        if cplx.is_cf(b):
            wide = torch.float64 if b.dtype == torch.float64 else torch.float32
            b = torch.complex(b.re.to(wide), b.im.to(wide))
        object.__setattr__(self, "blocks", b)
        cols = torch.as_tensor(self.block_cols, dtype=torch.long, device=b.device)
        object.__setattr__(self, "block_cols", cols)

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def block_size(self) -> int:
        return self.blocks.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        n = self.n_block_rows * self.block_size
        return (n, n)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def dtype(self) -> torch.dtype:
        """The real dtype of the fields it applies to."""
        return torch.float64 if self.blocks.dtype == torch.complex128 else torch.float32

    def apply(self, x):
        """Block SpMV (..., nb*ne) -> (..., nb*ne) on a complex tensor or a
        CF: y_r = sum_k blocks[r, k] @ x[block_cols[r, k]]
        (HierarchicalSparse.h:102-161) as one einsum."""
        nb, ne = self.n_block_rows, self.block_size
        xc = torch.complex(x.re, x.im) if cplx.is_cf(x) else x
        lead = tuple(xc.shape[:-1])
        gathered = xc.reshape(lead + (nb, ne))[..., self.block_cols, :]  # (..., nb, K, ne)
        y = torch.einsum("rkij,...rkj->...ri", self.blocks.to(xc.dtype), gathered)
        y = y.reshape(lead + (nb * ne,))
        return cplx.CF(y.real.contiguous(), y.imag.contiguous()) if cplx.is_cf(x) else y

    def val_at(self, row: int, col: int) -> complex:
        """Element lookup summing duplicate blocks (HierarchicalSparse.h:165-178)."""
        ne = self.block_size
        br, bi = divmod(int(row), ne)
        bc, bj = divmod(int(col), ne)
        hit = self.block_cols[br] == bc
        return complex(self.blocks[br, :, bi, bj][hit].sum())

    def to_dense(self) -> torch.Tensor:
        """The (nc, nc) complex matrix; duplicate blocks add."""
        nb, k, ne, _ = self.blocks.shape
        dev = self.blocks.device
        e = torch.arange(ne, device=dev)
        rows = (torch.arange(nb, device=dev)[:, None, None, None] * ne + e[None, None, :, None])
        cols = self.block_cols[:, :, None, None] * ne + e[None, None, None, :]
        idx = tuple(t.reshape(-1) for t in torch.broadcast_tensors(rows, cols))
        flat = self.blocks.reshape(-1)
        parts = []
        for part in (flat.real, flat.imag):  # real planes: a plain accumulate on every device
            dense = torch.zeros((nb * ne, nb * ne), dtype=part.dtype, device=dev)
            dense.index_put_(idx, part, accumulate=True)
            parts.append(dense)
        return torch.complex(*parts)
