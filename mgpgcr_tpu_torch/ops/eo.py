"""Even-odd (red-black) decomposition of the Wilson--Dirac operator.

Counterpart of ``mgpgcr_tpu/ops/eo.py``. The hopping matrix D couples only
sites of opposite parity p(t, z, y, x) = (t + z + y + x) mod 2, so in
parity order

    A = I - k D = [[ I        , -k D_eo ],
                   [ -k D_oe  ,  I      ]]

and the even-site Schur complement is S = I - k^2 D_eo D_oe, a
half-dimension system whose spectrum is the squared hopping spectrum.
Solving A x = b reduces to

    rhs_e = b_e + k D_eo b_o,   S x_e = rhs_e,   x_o = b_o + k D_oe x_e

(``solvers/eo.py``).

Compact layout: a parity field keeps the slab layout with the merged
minor axis halved, ``(4, 3, T, Z, Y*(X/2))``. Site (t, z, y, x) of parity
p lives at xh = x // 2; within a (t, z, y) row the stored sites sit at
x = 2 xh + o with the row offset o = (t + z + y + p) mod 2. The t, z and y
hops leave xh unchanged (plain rolls, as on the full lattice); an x hop is
a conditional shift: forward reads xh + o, backward xh + o - 1, a per-row
select between the field and its segment-rolled copy.

Plain PyTorch, as the JAX form is XLA over ``wilson_tpu``'s half-spinor
helpers; the port's are ``ops/wilson_slab.py``'s. No kernel of the port.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.wilson_slab import accumulate_half, colour_mul, project_half
from mgpgcr_tpu_torch.parallel.halo import periodic_shift


@functools.lru_cache(maxsize=64)
def _masks(dims: tuple[int, ...], parity: int, device: torch.device):
    """(o, last, first) on ``device``: o the (T, Z, Y*(X/2)) mask of rows
    whose offset (t + z + y + parity) mod 2 is 1 (stored x odd); last and
    first mark xh == X/2 - 1 and xh == 0 along the merged axis."""
    t, z, y, xx = dims
    xh = xx // 2
    tt, zz, yy = np.meshgrid(np.arange(t), np.arange(z), np.arange(y), indexing="ij")
    o = np.repeat((tt + zz + yy + parity) % 2 == 1, xh, axis=-1)
    xcoord = np.tile(np.arange(xh), y)
    return tuple(torch.as_tensor(m).to(device) for m in (o, xcoord == xh - 1, xcoord == 0))


def field_to_eo(x, mesh: LatticeMesh):
    """Slab field (..., T, Z, Y*X) -> (even, odd) compact parity fields
    (..., T, Z, Y*(X/2)); any leading axes (fields, links); a CF or a
    tensor. Reshapes and selects, no gathers."""
    t, z, y, xx = mesh.spacetime_dims
    if xx % 2:
        raise ValueError("even-odd needs an even X extent")
    xh = xx // 2
    lat = x.reshape(tuple(x.shape[:-1]) + (y, xx))
    a, b = lat[..., 0::2], lat[..., 1::2]  # x = 0, 2, ... and x = 1, 3, ...
    a = a.reshape(tuple(a.shape[:-2]) + (y * xh,))
    b = b.reshape(tuple(b.shape[:-2]) + (y * xh,))
    o_even = _masks(mesh.spacetime_dims, 0, x.device)[0]  # rows whose even sites sit at odd x
    w = cplx.where if cplx.is_cf(x) else torch.where
    return w(o_even, b, a), w(o_even, a, b)


def field_from_eo(even, odd, mesh: LatticeMesh):
    """Inverse of :func:`field_to_eo`."""
    t, z, y, xx = mesh.spacetime_dims
    xh = xx // 2
    o_even = _masks(mesh.spacetime_dims, 0, even.device)[0]
    w = cplx.where if cplx.is_cf(even) else torch.where
    a = w(o_even, odd, even)  # entries at even x
    b = w(o_even, even, odd)  # entries at odd x
    a = a.reshape(tuple(a.shape[:-1]) + (y, xh))
    b = b.reshape(tuple(b.shape[:-1]) + (y, xh))
    lat = cplx.stack([a, b], axis=a.ndim) if cplx.is_cf(even) else torch.stack([a, b], a.ndim)
    return lat.reshape(tuple(lat.shape[:-3]) + (y * xx,))


@dataclasses.dataclass(frozen=True)
class EvenOddWilson:
    """The parity blocks D_eo and D_oe of the Wilson--Dirac stencil on
    compact parity fields (4, 3, T, Z, Y*(X/2)). ``links_e`` / ``links_o``
    are the links based at even / odd sites, mu-major (4, 3, 3, T, Z,
    Y*(X/2)) CFs; arithmetic in the field's dtype."""

    links_e: cplx.CF
    links_o: cplx.CF
    mesh: LatticeMesh
    # on one shard of a lattice split over (t, z) (``solvers/eo.py::
    # eo_sharded``): ``mesh`` is the shard's, the t and z hops take their
    # boundary planes from the ring neighbours through ``comm``
    comm: object = None
    axis_t: str | None = None
    axis_z: str | None = None

    @staticmethod
    def from_full(links_slab: cplx.CF, mesh: LatticeMesh) -> "EvenOddWilson":
        """Split full-lattice mu-major slab links (4, 3, 3, T, Z, Y*X)."""
        links_e, links_o = field_to_eo(links_slab, mesh)
        return EvenOddWilson(links_e.contiguous(), links_o.contiguous(), mesh)

    @staticmethod
    def from_dirac(d) -> "EvenOddWilson":
        """From a stencil operator (``CudaWilsonDirac`` on t-major or
        mu-major links, or ``SlabWilsonDirac``), honouring its boundary.

        ``CudaWilsonDirac`` on t-major links applies the anti-periodic t
        sign in the kernel (``d.anti_t``) and keeps the stored links
        pristine; the parity split works from the links alone, so the sign
        is folded into U_t(T-1) here, else the Schur system would be the
        periodic operator. mu-major storage has it folded already
        (``anti_t`` False). Two-row compressed links are refused: the
        parity blocks need full 3x3 links."""
        from mgpgcr_tpu_torch.ops.dslash import links_from_tmajor

        links = d.links
        if getattr(d, "t_major", False):
            if links.shape[2] != 3:
                raise ValueError("even-odd needs uncompressed (3-row) links")
            links = links_from_tmajor(links)
        mesh = d.mesh
        if getattr(d, "anti_t", False):
            links = links.clone()
            tl = mesh.spacetime_dims[0] - 1
            links.re[0, :, :, tl] *= -1
            links.im[0, :, :, tl] *= -1
        return EvenOddWilson.from_full(links, mesh)

    @property
    def field_shape(self) -> tuple[int, ...]:
        t, z, y, xx = self.mesh.spacetime_dims
        return (4, 3, t, z, y * (xx // 2))

    @property
    def half_dim(self) -> int:
        """Half the full operator's dimension (of the shard's, when split)."""
        return self.mesh.size // 2

    @property
    def device(self) -> torch.device:
        return self.links_e.device

    @property
    def dtype(self) -> torch.dtype:
        """Field dtype: f32 for reduced-precision link storage."""
        return torch.float64 if self.links_e.dtype == torch.float64 else torch.float32

    def _shift(self, v: cplx.CF, mu: int, fwd: bool, parity_out: int) -> cplx.CF:
        """The neighbour's value on compact parity fields; v is (3, T, Z, V/2)."""
        t, z, y, xx = self.mesh.spacetime_dims
        xh = xx // 2
        if mu in (0, 1):
            return periodic_shift(v, v.ndim - 3 + mu, -1 if fwd else 1, self.comm,
                                  self.axis_t if mu == 0 else self.axis_z)
        ax = v.ndim - 1
        if mu == 2:
            return cplx.roll(v, -xh if fwd else xh, ax)
        # x hop: rows with offset 1 shift forward by one xh plane (periodic
        # within the row); rows with offset 0 shift backward
        o1, last, first = _masks(self.mesh.spacetime_dims, parity_out, v.device)
        if fwd:  # input index xh + o
            seg = cplx.where(last, cplx.roll(v, xh - 1, ax), cplx.roll(v, -1, ax))
            return cplx.where(o1, seg, v)
        seg = cplx.where(first, cplx.roll(v, -(xh - 1), ax), cplx.roll(v, 1, ax))
        return cplx.where(o1, v, seg)  # input index xh + o - 1

    def _apply(self, psi: cplx.CF, parity_out: int) -> cplx.CF:
        """D restricted from parity 1 - parity_out to parity_out."""
        links_out = (self.links_e if parity_out == 0 else self.links_o).astype(psi.dtype)
        links_in = (self.links_o if parity_out == 0 else self.links_e).astype(psi.dtype)
        psi_slabs = [psi[s] for s in range(4)]
        out = [None] * 4
        for mu in range(4):
            # forward: (1 - gamma_mu) U_mu(s) psi(s + mu), U at the output site
            h = [self._shift(hq, mu, True, parity_out)
                 for hq in project_half(psi_slabs, mu, True)]
            out = accumulate_half(out, colour_mul(links_out[mu], h, dagger=False), mu, True)
            # backward: (1 + gamma_mu) U_mu(s - mu)^dag psi(s - mu), the
            # product formed at the source site, then shifted
            w = colour_mul(links_in[mu], project_half(psi_slabs, mu, False), dagger=True)
            w = [self._shift(wq, mu, False, parity_out) for wq in w]
            out = accumulate_half(out, w, mu, False)
        return cplx.stack(out, axis=0)

    def apply_eo(self, psi_odd: cplx.CF) -> cplx.CF:
        """D_eo: an odd-parity field -> an even-parity field."""
        return self._apply(psi_odd, 0)

    def apply_oe(self, psi_even: cplx.CF) -> cplx.CF:
        """D_oe: an even-parity field -> an odd-parity field."""
        return self._apply(psi_even, 1)


@dataclasses.dataclass(frozen=True)
class SchurDirac(LinearOperator):
    """The even-site Schur complement S = I - k^2 D_eo D_oe as a solver
    operator on compact even-parity fields; ``k`` a complex 0-d tensor on
    the links' device."""

    eo: EvenOddWilson
    k: torch.Tensor

    def __post_init__(self):
        k = self.k
        if not isinstance(k, torch.Tensor):
            k = torch.tensor(complex(k), dtype=cplx.complex_dtype(self.eo.dtype))
        object.__setattr__(self, "k", k.to(self.eo.device))

    @property
    def shape(self) -> tuple[int, int]:
        n = self.eo.half_dim
        return (n, n)

    @property
    def field_shape(self) -> tuple[int, ...]:
        return self.eo.field_shape

    @property
    def device(self) -> torch.device:
        return self.eo.device

    @property
    def dtype(self) -> torch.dtype:
        return self.eo.dtype

    def apply(self, x_even: cplx.CF) -> cplx.CF:
        k2 = self.k * self.k
        return x_even - self.eo.apply_eo(self.eo.apply_oe(x_even)) * k2


def make_schur(eo: EvenOddWilson, k, dtype=torch.float32) -> SchurDirac:
    """S for hopping parameter ``k``, held at ``dtype``'s precision."""
    cdt = cplx.complex_dtype(dtype)
    kt = k.to(cdt) if isinstance(k, torch.Tensor) else torch.tensor(complex(k), dtype=cdt)
    return SchurDirac(eo, kt)
