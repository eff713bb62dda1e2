"""Wilson--Dirac hopping operator: gamma matrices, gauge links, and the
numpy oracle.

Counterpart of ``mgpgcr_tpu/ops/wilson.py``. The hopping operator is

    D psi(x) = sum_mu [ (1 - gamma_mu) U_mu(x) psi(x+mu)
                      + (1 + gamma_mu) U_mu^dag(x-mu) psi(x-mu) ],

in the Dirac basis (the one implied by the reference's gamma5 spinor swap
0<->2, 1<->3, Fields.h:311-338):
  gamma_t = diag(1, 1, -1, -1),  gamma_i = [[0, -i sigma_i], [i sigma_i, 0]],
  gamma_5 = [[0, I], [I, 0]],
with sigma3 -> z, sigma2 -> y, sigma1 -> x for the dim order (t, z, y, x).
Links are canonical ``(4, T, Z, Y, X, 3, 3)`` complex arrays;
``WilsonDiracOperator`` applies D to canonical (flat or lattice-shaped)
fields in plain PyTorch, as the JAX package's form is XLA;
``dirac_apply_np`` is the port's own numpy oracle of A = I - kD; and
``materialize_csr`` / ``materialize_ell`` assemble D as an explicit matrix
in the reference fixtures' layout (the ingestion path's test input).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.csr import CSRMatrix
from mgpgcr_tpu_torch.ops.ell import ELLOperator

_S1 = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_S2 = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_S3 = np.array([[1, 0], [0, -1]], dtype=np.complex128)
_I2 = np.eye(2, dtype=np.complex128)
_Z2 = np.zeros((2, 2), dtype=np.complex128)


def _blk(a, b, c, d):
    return np.block([[a, b], [c, d]])


# Hermitian gamma matrices: they make D gamma5-hermitian and every hopping
# projector (1 -+ gamma_mu) rank 2 (the half-spinor trick of the kernels).
GAMMA = np.stack(
    [
        _blk(_I2, _Z2, _Z2, -_I2),  # gamma_t
        _blk(_Z2, -1j * _S3, 1j * _S3, _Z2),  # gamma_z
        _blk(_Z2, -1j * _S2, 1j * _S2, _Z2),  # gamma_y
        _blk(_Z2, -1j * _S1, 1j * _S1, _Z2),  # gamma_x
    ]
)
GAMMA5 = _blk(_Z2, _I2, _I2, _Z2)

# hopping spin projectors: forward 1 - gamma_mu, backward 1 + gamma_mu
P_MINUS = np.stack([np.eye(4) - GAMMA[mu] for mu in range(4)])
P_PLUS = np.stack([np.eye(4) + GAMMA[mu] for mu in range(4)])


def random_links_np(seed: int, mesh: LatticeMesh) -> np.ndarray:
    """Haar-random SU(3) links (4, T, Z, Y, X, 3, 3), complex128: QR of a
    Ginibre matrix, phase fix, projection U(3) -> SU(3). Same construction
    and the same numbers as the JAX package's ``random_links_np``."""
    rng = np.random.default_rng(seed)
    shape = (4, *mesh.spacetime_dims, 3, 3)
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    q, r = np.linalg.qr(z)
    d = np.einsum("...ii->...i", r)
    q = q * (d / np.abs(d))[..., None, :]
    det = np.linalg.det(q)
    return q / det[..., None, None] ** (1.0 / 3.0)


def random_links(generator: torch.Generator, mesh: LatticeMesh,
                 dtype=torch.complex128) -> torch.Tensor:
    """Haar-random SU(3) links (4, T, Z, Y, X, 3, 3) on the generator's
    device, by the construction of :func:`random_links_np`; a
    ``torch.Generator`` gives other numbers than the JAX key or the numpy
    seed, so parity tests feed numpy links to both sides."""
    shape = (4, *mesh.spacetime_dims, 3, 3)
    dev = generator.device
    re = torch.randn(shape, generator=generator, dtype=torch.float64, device=dev)
    im = torch.randn(shape, generator=generator, dtype=torch.float64, device=dev)
    q, r = torch.linalg.qr(torch.complex(re, im))
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    q = q * (d / d.abs())[..., None, :]
    det = torch.linalg.det(q)
    return (q / det[..., None, None] ** (1.0 / 3.0)).to(dtype)


def random_links_cf(generator: torch.Generator, mesh: LatticeMesh,
                    dtype=torch.float32) -> cplx.CF:
    """:func:`random_links` as a split re/im CF of ``dtype``."""
    u = random_links(generator, mesh)
    return cplx.CF(u.real.to(dtype).contiguous(), u.imag.to(dtype).contiguous())


def unit_links(mesh: LatticeMesh) -> np.ndarray:
    """Free-field (identity) links (4, T, Z, Y, X, 3, 3), complex128."""
    eye = np.eye(3, dtype=np.complex128)
    return np.broadcast_to(eye, (4, *mesh.spacetime_dims, 3, 3)).copy()


def antiperiodic_t(links):
    """Anti-periodic temporal boundary condition as a link map: negates
    U_t on the t = T-1 slice of canonical links (a complex ndarray or a
    ``cplx.CF`` of tensors). The flipped links have det = -1, so two-row
    compression no longer reconstructs them: for a compressed operator use
    ``build(..., antiperiodic_t=True)``, which applies the sign in-kernel."""
    if cplx.is_cf(links):
        return cplx.CF(antiperiodic_t(links.re), antiperiodic_t(links.im))
    out = links.clone() if hasattr(links, "clone") else np.array(links, copy=True)
    out[0, -1] = -out[0, -1]
    return out


@dataclasses.dataclass(frozen=True)
class WilsonDiracOperator(LinearOperator):
    """Matrix-free hopping operator D on canonical fields (no diagonal: pair
    with ``DiracOperator`` for A = I - kD). Counterpart of the JAX
    package's ``WilsonDiracOperator``: neighbours by ``torch.roll``, colour
    and spin products by ``einsum``."""

    links: torch.Tensor  # (4, T, Z, Y, X, 3, 3) complex (an ndarray is converted)
    mesh: LatticeMesh

    def __post_init__(self):
        object.__setattr__(self, "links", torch.as_tensor(self.links))

    @property
    def shape(self) -> tuple[int, int]:
        return (self.mesh.size, self.mesh.size)

    @property
    def device(self) -> torch.device:
        return self.links.device

    @property
    def dtype(self) -> torch.dtype:
        """The real dtype of the links (the field dtype of CF fields)."""
        return torch.float64 if self.links.dtype == torch.complex128 else torch.float32

    def apply(self, x):
        """D x on a complex tensor or a CF, flat (..., N) or lattice-shaped
        (..., T, Z, Y, X, 4, 3)."""
        xc = torch.complex(x.re, x.im) if cplx.is_cf(x) else x
        flat = xc.ndim < len(self.mesh.dims)
        psi = self.mesh.to_lattice(xc) if flat else xc
        u_all = self.links.to(psi.dtype)
        out = torch.zeros_like(psi)
        for mu in range(4):
            axis = psi.ndim - 6 + mu
            u = u_all[mu]
            pm = torch.as_tensor(P_MINUS[mu], dtype=psi.dtype, device=psi.device)
            pp = torch.as_tensor(P_PLUS[mu], dtype=psi.dtype, device=psi.device)
            # forward: (1 - gamma_mu) U_mu(x) psi(x + mu)
            fwd = torch.einsum("tzyxab,...tzyxsb->...tzyxsa", u, torch.roll(psi, -1, axis))
            out = out + torch.einsum("st,...tc->...sc", pm, fwd)
            # backward: (1 + gamma_mu) U_mu^dag(x - mu) psi(x - mu)
            udag = torch.roll(u.conj().transpose(-1, -2), 1, mu)
            bwd = torch.einsum("tzyxab,...tzyxsb->...tzyxsa", udag, torch.roll(psi, 1, axis))
            out = out + torch.einsum("st,...tc->...sc", pp, bwd)
        out = self.mesh.to_flat(out) if flat else out
        return cplx.CF(out.real.contiguous(), out.imag.contiguous()) if cplx.is_cf(x) else out


def dirac_apply_np(
    links: np.ndarray, mesh: LatticeMesh, x: np.ndarray, k: complex = 0.0
) -> np.ndarray:
    """A x = x - k D x in numpy complex128 on a canonical flat field
    (index ((site*4 + spinor)*3 + colour), sites row-major t, z, y, x);
    k = 0 gives the bare hopping D. Reference operator: Operator.h:570-574."""
    links = np.asarray(links, np.complex128)
    st = mesh.spacetime_dims
    psi = np.asarray(x, np.complex128).reshape(*st, 4, 3)
    out = np.zeros_like(psi)
    for mu in range(4):
        u = links[mu]
        fwd = np.roll(psi, -1, axis=mu)
        fwd = np.einsum("tzyxab,tzyxsb->tzyxsa", u, fwd)
        out += np.einsum("ij,tzyxjc->tzyxic", P_MINUS[mu], fwd)
        udag = np.roll(u.conj().swapaxes(-1, -2), 1, axis=mu)
        bwd = np.roll(psi, 1, axis=mu)
        bwd = np.einsum("tzyxab,tzyxsb->tzyxsa", udag, bwd)
        out += np.einsum("ij,tzyxjc->tzyxic", P_PLUS[mu], bwd)
    res = psi - k * out if k else out
    return res.reshape(-1)


def materialize_csr(links, mesh: LatticeMesh) -> CSRMatrix:
    """D as an explicit host CSR matrix in the reference fixtures' layout:
    row / column index ((site * 4) + spinor) * 3 + colour, sites row-major
    in (t, z, y, x). Links are canonical complex (4, T, Z, Y, X, 3, 3)."""
    links = np.asarray(links)
    st = mesh.spacetime_dims
    n_sites = mesh.n_sites
    site_idx = np.arange(n_sites).reshape(st)
    rows_all, cols_all, vals_all = [], [], []
    for mu in range(4):
        nbr_fwd = np.roll(site_idx, -1, axis=mu).ravel()
        nbr_bwd = np.roll(site_idx, 1, axis=mu).ravel()
        u = links[mu].reshape(n_sites, 3, 3)
        udag = np.roll(links[mu], 1, axis=mu).reshape(n_sites, 3, 3).conj().transpose(0, 2, 1)
        for proj, nbr, umat in ((P_MINUS[mu], nbr_fwd, u), (P_PLUS[mu], nbr_bwd, udag)):
            for s, t in zip(*np.nonzero(np.abs(proj) > 1e-14)):
                for c in range(3):
                    for b in range(3):
                        rows_all.append(np.arange(n_sites) * 12 + s * 3 + c)
                        cols_all.append(nbr * 12 + t * 3 + b)
                        vals_all.append(proj[s, t] * umat[:, c, b])
    return CSRMatrix.from_triplets(np.concatenate(rows_all), np.concatenate(cols_all),
                                   np.concatenate(vals_all), (mesh.size, mesh.size))


def materialize_ell(links, mesh: LatticeMesh, dtype=None, device=None) -> ELLOperator:
    """:func:`materialize_csr` in ELL form on ``device`` (CUDA unless named)."""
    return materialize_csr(links, mesh).to_ell(dtype=dtype, device=device)
