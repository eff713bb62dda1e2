"""The Wilson--Dirac operator of the Dslash kernels: t-major link storage,
two-row SU(3) compression, mu-major storage, and the converters that carry
numpy state into the port.

Counterpart of the host side of ``mgpgcr_tpu/ops/pallas/dslash.py``
(``links_to_tmajor`` .. ``_assert_su3_compressible`` and
``PallasWilsonDirac``, single-device branch; ``_reconstruct_su3`` lives
beside the kernel's plain version, ``kernels/dslash.py::reconstruct_su3``). Links are stored t-major ``(T, 4, R, 3, Z, Y*X)``
with R = 3 rows, or R = 2 when compressed (row 2 = conj(row0 x row1) is
rebuilt in the kernel); storage is f32 or bf16, arithmetic f32. The
anti-periodic temporal boundary sign is applied in the kernel, so stored
links stay pristine SU(3) and compression composes with it. Asked for
``tb > 1`` or ``zb < Z`` (the JAX package's blocked kernel), ``build``
stores mu-major 3-row links ``(4, 3, 3, T, Z, Y*X)`` instead, with the
boundary sign folded into U_t(T-1), and the operator runs the mu-major
Dslash kernel (B13); tb and zb select that storage only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels.dslash import dslash_apply, dslash_mu, reconstruct_su3
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.wilson_slab import links_to_slab


def links_to_tmajor(links_slab: cplx.CF) -> cplx.CF:
    """mu-major (4, 3, 3, T, Z, V) -> t-major (T, 4, 3, 3, Z, V)."""
    return links_slab.permute(3, 0, 1, 2, 4, 5).contiguous()


def links_from_tmajor(links_tmajor: cplx.CF) -> cplx.CF:
    """Inverse of :func:`links_to_tmajor` (3-row links only)."""
    if links_tmajor.shape[2] != 3:
        raise ValueError("two-row links cannot round-trip")
    return links_tmajor.permute(1, 2, 3, 0, 4, 5).contiguous()


def compress_links_tmajor(links_tmajor: cplx.CF) -> cplx.CF:
    """(T, 4, 3, 3, Z, V) -> (T, 4, 2, 3, Z, V): drop row 2 of every SU(3)
    link (12-real gauge compression); valid only for true SU(3) links."""
    return links_tmajor[:, :, :2].contiguous()


def su3_reconstruction_error(links_tmajor: cplx.CF) -> float:
    """Max |row2 - conj(row0 x row1)| over all links; 0 for exact SU(3),
    O(1) where a boundary link was sign-flipped (det = -1)."""
    full = reconstruct_su3(links_tmajor[:, :, :2], torch.float32)
    d = links_tmajor[:, :, 2].astype(torch.float32) - full[:, :, 2]
    return float(torch.sqrt(torch.max(cplx.abs2(d))))


def _assert_su3_compressible(links_tmajor: cplx.CF) -> None:
    """Refuse two-row compression of links that are not SU(3)."""
    err = su3_reconstruction_error(links_tmajor)
    if err > 0.1:
        raise ValueError(
            "links fail SU(3) row-reconstruction (max error "
            f"{err:.3g}): two-row compression would corrupt the operator. "
            "If these links carry the anti-periodic boundary sign, rebuild "
            "from pristine links with build(..., antiperiodic_t=True)."
        )


def _canonical_cf(links_canonical, device, dtype) -> cplx.CF:
    """Canonical (4, T, Z, Y, X, 3, 3) links given as a complex ndarray, a
    (re, im) pair of ndarrays, or a CF of tensors -> CF on ``device``."""
    if cplx.is_cf(links_canonical):
        return links_canonical.to(device, dtype)
    if isinstance(links_canonical, (tuple, list)):
        re, im = links_canonical
    else:
        z = np.asarray(links_canonical)
        re, im = z.real, z.imag
    return cplx.CF(
        torch.as_tensor(np.ascontiguousarray(re)).to(device, dtype),
        torch.as_tensor(np.ascontiguousarray(im)).to(device, dtype),
    )


def links_from_numpy(
    links_canonical,
    mesh: LatticeMesh,
    device=None,
    compress: bool = False,
    link_dtype=torch.float32,
) -> cplx.CF:
    """The JAX package's canonical links -> the port's t-major storage.

    ``links_canonical``: (4, T, Z, Y, X, 3, 3) complex ndarray, or the
    ``re``/``im`` pair of the ``data/*.npz`` files. Returns the
    (T, 4, R, 3, Z, Y*X) CF on ``device`` (CUDA unless named), R = 2 with
    ``compress``, stored as ``link_dtype``. The relayout runs on the device."""
    dev = cplx.resolve_device(device)
    wide = torch.float64 if link_dtype == torch.float64 else torch.float32
    links = links_to_tmajor(links_to_slab(_canonical_cf(links_canonical, dev, wide), mesh))
    if compress:
        _assert_su3_compressible(links)
        links = compress_links_tmajor(links)
    return links.astype(link_dtype)


def field_from_numpy(x: np.ndarray, dtype=torch.float32, device=None) -> cplx.CF:
    """(4, 3, T, Z, Y*X) complex ndarray -> CF on ``device`` (CUDA unless
    named)."""
    return cplx.from_numpy(x, dtype, device)


def field_to_numpy(x: cplx.CF) -> np.ndarray:
    """CF field -> (4, 3, T, Z, Y*X) complex128 ndarray."""
    return cplx.to_numpy(x)


@dataclasses.dataclass(frozen=True)
class CudaWilsonDirac(LinearOperator):
    """Hopping operator D on slab fields (4, 3, T, Z, Y*X) backed by the
    hand-written Dslash kernels (counterpart of ``PallasWilsonDirac``,
    single device): K1 on t-major links, B13 on mu-major ones. ``anti_t``
    applies the anti-periodic temporal boundary sign in K1. CPU tensors
    take the kernels' plain versions."""

    links: cplx.CF  # t-major (T, 4, R, 3, Z, Y*X), R = 3 or 2; or (4, 3, 3, T, Z, Y*X)
    mesh: LatticeMesh
    anti_t: bool = False
    tb: int | None = None  # the JAX package's (t, z) blocks: select the
    zb: int | None = None  # mu-major storage, no blocking on the card

    @staticmethod
    def build(
        links_canonical,
        mesh: LatticeMesh,
        compress: bool = False,
        antiperiodic_t: bool = False,
        link_dtype=torch.float32,
        device=None,
        tb: int | None = None,
        zb: int | None = None,
    ) -> "CudaWilsonDirac":
        """``antiperiodic_t=True`` expects pristine periodic links and
        applies the boundary sign in the kernel (do not also pre-flip them
        with ``ops/wilson.py::antiperiodic_t``). With ``tb > 1`` or
        ``zb < Z`` (``PallasWilsonDirac.build``'s blocked kernel) the links
        are stored mu-major with 3 rows and the sign is folded into
        U_t(T-1) instead; ``compress`` is refused there."""
        t, z = mesh.spacetime_dims[:2]
        if tb in (None, 1) and zb in (None, z):
            links = links_from_numpy(links_canonical, mesh, device, compress, link_dtype)
            return CudaWilsonDirac(links, mesh, bool(antiperiodic_t), tb, zb)
        if t % (tb or 1) or z % (zb or z):
            raise ValueError(f"blocks tb={tb}, zb={zb} do not divide T={t}, Z={z}")
        if compress:
            raise ValueError("link compression requires t-major links (tb in (None, 1), zb = Z)")
        dev = cplx.resolve_device(device)
        wide = torch.float64 if link_dtype == torch.float64 else torch.float32
        links = links_to_slab(_canonical_cf(links_canonical, dev, wide), mesh)
        if antiperiodic_t:
            links.re[0, :, :, t - 1] *= -1
            links.im[0, :, :, t - 1] *= -1
        return CudaWilsonDirac(links.astype(link_dtype), mesh, False, tb, zb)

    @property
    def t_major(self) -> bool:
        """True for t-major links (K1), False for mu-major ones (B13)."""
        return self.links.shape[1] == 4

    @property
    def shape(self) -> tuple[int, int]:
        return (self.mesh.size, self.mesh.size)

    @property
    def field_shape(self) -> tuple[int, ...]:
        t, z, y, xx = self.mesh.spacetime_dims
        return (4, 3, t, z, y * xx)

    @property
    def device(self) -> torch.device:
        return self.links.device

    @property
    def dtype(self) -> torch.dtype:
        """Field dtype: f32 for reduced-precision link storage."""
        dt = self.links.dtype
        return torch.float64 if dt == torch.float64 else torch.float32

    def apply(self, psi: cplx.CF) -> cplx.CF:
        if not self.t_major:
            return dslash_mu(self.links, psi, self.mesh)
        return dslash_apply(self.links, psi, self.mesh, anti_t=self.anti_t)

    def apply_dirac(self, psi: cplx.CF, k) -> cplx.CF:
        """A psi = psi - k D psi in one kernel pass (Operator.h:570-574)."""
        k = cplx.scalar(k, psi)
        if not self.t_major:
            return dslash_mu(self.links, psi, self.mesh, k=k)
        return dslash_apply(self.links, psi, self.mesh, k=k, anti_t=self.anti_t)
