"""The Wilson--Dirac operator on one shard of a lattice split over (t, z).

Counterpart of ``PallasWilsonDirac.build_sharded`` / ``local_mesh`` /
``apply_local`` (``mgpgcr_tpu/ops/pallas/dslash.py``) and of
``ShardLocalWilsonDirac`` (``mgpgcr_tpu/ops/pallas/gcr_dslash_dist.py``).
Each rank holds its t-major link slab and the two link ghosts its stencil
reads past its low edges; ``apply`` and ``apply_dirac`` run B14, and the
fused GCR solver routes its iterations through B15 on this operator
(``solvers/gcr.py::_mega_step_config``). The anti-periodic temporal sign
rides in the exchanged psi ghosts, so the links stay pristine SU(3) and
two-row compression composes with it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.kernels.dslash_dist import dslash_apply_local
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.dslash import links_from_numpy


def _take(links, axis: int, idx: list):
    """``links`` (a complex ndarray, an (re, im) pair of ndarrays, or a CF)
    at the indices ``idx`` of ``axis``, in the same form."""
    if cplx.is_cf(links):
        i = torch.as_tensor(idx, device=links.device)
        return cplx.CF(links.re.index_select(axis, i), links.im.index_select(axis, i))
    if isinstance(links, (tuple, list)):
        return tuple(np.take(p, idx, axis=axis) for p in links)
    return np.take(np.asarray(links), idx, axis=axis)


@dataclasses.dataclass(frozen=True)
class ShardLocalWilsonDirac(LinearOperator):
    """Hopping operator D on this rank's shard (4, 3, T_l, Z_l, Y*X) of a
    lattice split over grid axes ``axis_t`` and ``axis_z`` (None: not
    split). Every rank must apply it together."""

    links: cplx.CF  # this rank's t-major (T_l, 4, R, 3, Z_l, Y*X) slab
    ghost_links: tuple  # (U_t at t = -1: (1, 1, R, 3, Z_l, V); U_z at z = -1: (T_l, 1, R, 3, 1, V) or None)
    mesh: LatticeMesh  # the global lattice
    local_mesh: LatticeMesh
    comm: object
    axis_t: str | None = "t"
    axis_z: str | None = None
    anti_t: bool = False

    @staticmethod
    def build(links_canonical, mesh: LatticeMesh, comm, axis_t="t", axis_z=None,
              compress: bool = False, antiperiodic_t: bool = False,
              link_dtype=torch.float32, device=None) -> "ShardLocalWilsonDirac":
        """Cut this rank's slab and link ghosts out of the global canonical
        (4, T, Z, Y, X, 3, 3) links (as ``links_from_numpy`` takes them)
        and store them t-major on ``device`` (the rank's device unless
        named), two-row with ``compress``. ``antiperiodic_t`` expects
        pristine periodic links. Raises where the grid does not split T or
        Z evenly."""
        t, z, y, xx = mesh.spacetime_dims
        nt, nz = comm.axis_size(axis_t), comm.axis_size(axis_z)
        if t % nt or z % nz:
            raise ValueError(f"lattice (T={t}, Z={z}) does not tile the grid ({nt} x {nz})")
        tl, zl = t // nt, z // nz
        t0, z0 = comm.axis_index(axis_t) * tl, comm.axis_index(axis_z) * zl
        zo = int(nz > 1)  # a U_z ghost column only when z is split
        # the slab with one more site below it along t (and z): U_t(t0 - 1)
        # and U_z(z0 - 1) of the neighbouring ranks, periodic
        ext = _take(links_canonical, 1, [(t0 - 1) % t] + list(range(t0, t0 + tl)))
        ext = _take(ext, 2, [(z0 - 1) % z] * zo + list(range(z0, z0 + zl)))
        full = links_from_numpy(ext, LatticeMesh((tl + 1, zl + zo, y, xx, 4, 3)),
                                comm.device if device is None else device, compress, link_dtype)
        ut = full[:1, :1, :, :, zo:].contiguous()
        uz = full[1:, 1:2, :, :, :1].contiguous() if zo else None
        return ShardLocalWilsonDirac(
            full[1:, :, :, :, zo:].contiguous(), (ut, uz), mesh,
            LatticeMesh((tl, zl, y, xx, 4, 3)), comm, axis_t, axis_z, bool(antiperiodic_t),
        )

    @property
    def shape(self) -> tuple[int, int]:
        return (self.mesh.size, self.mesh.size)

    @property
    def field_shape(self) -> tuple[int, ...]:
        t, z, y, xx = self.local_mesh.spacetime_dims
        return (4, 3, t, z, y * xx)

    @property
    def device(self) -> torch.device:
        return self.links.device

    @property
    def dtype(self) -> torch.dtype:
        """Field dtype: f32 for reduced-precision link storage."""
        return torch.float64 if self.links.dtype == torch.float64 else torch.float32

    def _apply(self, psi: cplx.CF, k) -> cplx.CF:
        return dslash_apply_local(self.links, self.ghost_links, psi, self.local_mesh, self.comm,
                                  self.axis_t, self.axis_z, k, self.anti_t)

    def apply(self, psi: cplx.CF) -> cplx.CF:
        return self._apply(psi, None)

    def apply_dirac(self, psi: cplx.CF, k) -> cplx.CF:
        """A psi = psi - k D psi in one B14 pass."""
        return self._apply(psi, cplx.scalar(k, psi))
