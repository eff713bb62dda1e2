"""Structure detection for ingested matrices: recognise Wilson--Dirac.

Counterpart of ``mgpgcr_tpu/ops/ingest.py``. The reference ingests its
hopping matrices from parsed fixture files and applies them through the
generic CSR row loop (Parse.cpp, Operator.h:331-346). ``detect_wilson``
factorises an ingested CSR matrix back into gauge links and the known spin
projectors, verifying the reconstruction against every non-zero, so that
the solve can run on the Dslash kernel (K1), which moves one 3x3 link per
hop instead of a dense 12x12 block. The detection is numpy on the host, a
copy of the JAX package's.

Conventions are those of ``ops/wilson.py::materialize_csr``: row index
(site * 4 + spin) * 3 + colour, sites row-major over (t, z, y, x); the
forward +mu block is P_MINUS[mu] (x) U_mu(x), the backward one
P_PLUS[mu] (x) U_mu(x - mu)^dagger.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator
from mgpgcr_tpu_torch.ops.blockstencil import detect_block_stencil
from mgpgcr_tpu_torch.ops.wilson import GAMMA5, P_MINUS, P_PLUS

_NS, _NC = 4, 3
_NE = _NS * _NC


@dataclasses.dataclass(frozen=True)
class WilsonDetection:
    """A successful factorisation.

    links: canonical complex128 (4, T, Z, Y, X, 3, 3) gauge field;
    diag: the uniform diagonal c (0 for a pure hopping matrix D);
    signs: the gamma sign convention s_mu of the ingested matrix (its
      forward hop is (1 - s_mu gamma_mu) (x) U); (+1,)*4 is this package's,
      the reference's 4^4 fixture has (+1, -1, -1, -1);
    spin_transform: real 4x4 S with S gamma_mu S^-1 = s_mu gamma_mu, so
      D_ingested = (S (x) 1) D_ours (S^-1 (x) 1) on the same links; None
      for s = (+1,)*4;
    max_error: the largest |reconstructed - ingested| over every non-zero.
    """

    links: np.ndarray
    diag: complex
    signs: tuple[int, int, int, int]
    spin_transform: np.ndarray | None
    max_error: float


def _spin_transform_for(signs: tuple[int, ...]):
    """S for a sign pattern that a Clifford element realises by conjugation
    (I: all +; gamma_t: the three spatial gammas flipped; gamma5: all four;
    gamma5 gamma_t: gamma_t only); False for any other pattern."""
    gt = np.diag([1.0, 1.0, -1.0, -1.0])  # gamma_t, real diagonal
    table = {
        (1, 1, 1, 1): None,
        (1, -1, -1, -1): gt,
        (-1, -1, -1, -1): np.real(GAMMA5),
        (-1, 1, 1, 1): np.real(GAMMA5) @ gt,
    }
    return table.get(tuple(signs), False)


def _kron_factor(slot: np.ndarray, proj: np.ndarray) -> np.ndarray:
    """U from site blocks assumed to be proj (x) U: (nb, 12, 12) -> (nb, 3,
    3), read at the largest projector entry; verified by the caller."""
    m = slot.reshape(-1, _NS, _NC, _NS, _NC).transpose(0, 1, 3, 2, 4)
    s0, t0 = np.unravel_index(np.argmax(np.abs(proj)), proj.shape)
    return m[:, s0, t0] / proj[s0, t0]


def detect_wilson(csr, dims: tuple[int, ...], tol: float = 1e-10) -> WilsonDetection | None:
    """Factorise an ingested CSR matrix as c I + sum_mu hops, or None.

    Needs a 4-D lattice ``dims`` with every extent >= 3 (shorter extents
    merge the +mu and -mu stencil slots), 12x12 site blocks, and every
    hopping block a Kronecker product, within ``tol``, of a Dirac-basis
    projector of ``ops/wilson.py`` and a 3x3 link."""
    if len(dims) != 4 or any(d < 3 for d in dims):
        return None
    blocks = detect_block_stencil(csr, dims, _NE)
    if blocks is None:
        return None
    nb = blocks.shape[0]

    self_blocks = blocks[:, 0]  # must be c * I_12
    c = complex(np.mean(np.einsum("nii->ni", self_blocks)))
    if not np.allclose(self_blocks, c * np.eye(_NE), atol=tol):
        return None
    if abs(c) < tol:
        c = 0.0

    links = np.empty((4, nb, _NC, _NC), dtype=np.complex128)
    max_err = 0.0
    signs = []
    site = np.arange(nb).reshape(dims)
    for mu in range(4):
        fwd = blocks[:, 1 + 2 * mu]  # (1 - s gamma_mu) (x) U_mu(x)
        bwd = blocks[:, 2 + 2 * mu]  # (1 + s gamma_mu) (x) U_mu(x - mu)^dag
        shift = np.roll(site, 1, axis=mu).ravel()
        best = None
        for s, proj_f, proj_b in ((+1, P_MINUS[mu], P_PLUS[mu]), (-1, P_PLUS[mu], P_MINUS[mu])):
            u = _kron_factor(fwd, proj_f)
            recon_f = np.einsum("st,nab->nsatb", proj_f, u).reshape(nb, _NE, _NE)
            err = np.max(np.abs(recon_f - fwd))
            if err > tol:
                continue
            # the backward block of row x couples to x - mu through U_mu(x - mu)^dag
            udag = u[shift].conj().transpose(0, 2, 1)
            recon_b = np.einsum("st,nab->nsatb", proj_b, udag).reshape(nb, _NE, _NE)
            err = max(err, float(np.max(np.abs(recon_b - bwd))))
            if err <= tol:
                best = (s, u, err)
                break
        if best is None:
            return None
        s, u, err = best
        links[mu] = u
        signs.append(s)
        max_err = max(max_err, err)

    signs = tuple(signs)
    st = _spin_transform_for(signs)
    if st is False:
        return None
    return WilsonDetection(links=links.reshape(4, *dims, _NC, _NC), diag=complex(c),
                           signs=signs, spin_transform=st, max_error=max_err)


@dataclasses.dataclass(frozen=True)
class SpinConjugatedOperator(LinearOperator):
    """(S (x) 1_colour) A (S^-1 (x) 1_colour) on slab fields (4, 3, T, Z,
    Y*X): routes an ingested matrix in a flipped gamma convention through
    the port's operators exactly. ``s`` is the real orthogonal 4x4 spin
    transform of ``detect_wilson`` (a real tensor), so S^-1 = S^T; two 4x4
    spin contractions per apply in plain PyTorch."""

    a: LinearOperator
    s: torch.Tensor  # (4, 4) real

    @property
    def shape(self):
        return self.a.shape

    @staticmethod
    def _spin(m: torch.Tensor, x: cplx.CF) -> cplx.CF:
        m = m.to(x.dtype)
        return cplx.CF(torch.einsum("st,...tcazv->...scazv", m, x.re),
                       torch.einsum("st,...tcazv->...scazv", m, x.im))

    def apply(self, x: cplx.CF) -> cplx.CF:
        return self._spin(self.s, self.a.apply(self._spin(self.s.T, x)))


def wilson_operator_from_csr(csr, dims: tuple[int, ...], k, dtype=torch.float32,
                             backend: str = "cuda", tol: float = 1e-10, device=None):
    """A = I - k D for an ingested Wilson-structured CSR matrix, on the
    slab fields (4, 3, T, Z, Y*X) of the port's operators; None when the
    matrix does not factorise.

    ``backend``: "cuda", a ``CudaWilsonDirac`` on 3-row t-major links (the
    Dslash kernel K1 on CUDA tensors, its plain version on CPU tensors), or
    "slab", a ``SlabWilsonDirac`` (plain PyTorch); on ``device`` (CUDA
    unless named), links stored as ``dtype``. In a flipped gamma convention
    the operator is wrapped in :class:`SpinConjugatedOperator`."""
    from mgpgcr_tpu_torch.ops.dirac import DiracOperator
    from mgpgcr_tpu_torch.ops.dslash import CudaWilsonDirac
    from mgpgcr_tpu_torch.ops.wilson_slab import SlabWilsonDirac

    if backend not in ("cuda", "slab"):
        raise ValueError(f"backend must be 'cuda' or 'slab', not {backend!r}")
    det = detect_wilson(csr, dims, tol=tol)
    if det is None:
        return None
    if det.diag != 0:
        raise ValueError(
            f"ingested matrix has a uniform diagonal {det.diag}; pass the pure hopping "
            "matrix D and fold the diagonal into k"
        )
    mesh = LatticeMesh((*dims, _NS, _NC))
    dev = cplx.resolve_device(device)
    if backend == "cuda":
        d = CudaWilsonDirac.build(det.links, mesh, link_dtype=dtype, device=dev)
    else:
        d = SlabWilsonDirac.build(cplx.from_numpy(det.links, dtype, dev), mesh)
    a = DiracOperator(d, k)
    if det.spin_transform is not None:
        # S (I - k D_ours) S^-1 = I - k S D_ours S^-1 = I - k D_ingested
        s = torch.as_tensor(det.spin_transform, dtype=d.dtype, device=dev)
        a = SpinConjugatedOperator(a, s)
    return a
