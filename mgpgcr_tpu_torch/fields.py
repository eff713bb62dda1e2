"""Field algebra: inner products, norms, random fields, gamma_5 and the
chiral projections, Gram--Schmidt.

Counterpart of ``mgpgcr_tpu/fields.py``. A field is a complex tensor
(flat ``(N,)``, lattice-shaped, or a stack) or a split re/im ``cplx.CF``
pair; the inner products accept either.
"""

from __future__ import annotations

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh


def random_field(
    generator: torch.Generator,
    mesh_or_shape,
    dtype=torch.complex128,
    device=None,
) -> torch.Tensor:
    """Random complex field with re, im ~ U[-1, 1) (Field::init_rand,
    Fields.h:126-135), drawn from ``generator`` on ``device`` (CUDA unless
    named; the generator must live there)."""
    if isinstance(mesh_or_shape, LatticeMesh):
        shape = (mesh_or_shape.size,)
    elif isinstance(mesh_or_shape, int):
        shape = (mesh_or_shape,)
    else:
        shape = tuple(mesh_or_shape)
    dev = cplx.resolve_device(device)
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    re = torch.rand(shape, generator=generator, dtype=rdt, device=dev)
    im = torch.rand(shape, generator=generator, dtype=rdt, device=dev)
    return torch.complex(2.0 * re - 1.0, 2.0 * im - 1.0).to(dtype)


def dot(a, b) -> torch.Tensor:
    """Conjugate inner product <a, b> = sum conj(a) b (Fields.h:217-226)."""
    if cplx.is_cf(a):
        return cplx.vdot(a, b)
    return torch.sum(torch.conj(a) * b)


def squared_norm(a) -> torch.Tensor:
    """||a||^2 as a real scalar (Fields.h:229-235)."""
    if cplx.is_cf(a):
        return cplx.abs2_sum(a)
    return torch.sum(a.real**2 + a.imag**2)


def norm(a) -> torch.Tensor:
    return torch.sqrt(squared_norm(a))


def normalize(a):
    """a / ||a|| (Fields.h:238-243)."""
    n = norm(a)
    return cplx.scale_real(a, 1.0 / n) if cplx.is_cf(a) else a / n.to(a.dtype)


def gamma5(x, mesh: LatticeMesh | None = None):
    """gamma_5 in the Dirac basis, the spinor swap 0<->2, 1<->3
    (Fields.h:311-338), on canonical fields: lattice-shaped (..., 4, 3), or
    flat (..., N) with ``mesh``. A complex tensor or a CF."""
    if x.ndim >= 2 and tuple(x.shape[-2:]) == (4, 3):
        xs, flat = x, False
    elif mesh is None:
        raise ValueError("flat fields need a mesh to locate the spinor axis")
    else:
        xs, flat = mesh.to_lattice(x), True
    axis = xs.ndim - 2
    if cplx.is_cf(xs):
        out = cplx.take(xs, [2, 3, 0, 1], axis=axis)
    else:
        out = torch.index_select(xs, axis, torch.tensor([2, 3, 0, 1], device=xs.device))
    return out.reshape(x.shape) if flat else out


def chiral_project(x, sign: int, mesh: LatticeMesh | None = None):
    """P_+- x = (x +- gamma_5 x) / 2, the chirality-preserving doubling of
    the MG setup (MG.h:317-345)."""
    g = gamma5(x, mesh)
    both = x + g if sign > 0 else x - g
    return cplx.scale_real(both, 0.5) if cplx.is_cf(both) else 0.5 * both


def gram_schmidt(vectors):
    """Modified Gram--Schmidt orthonormalisation of the rows of an (n, N)
    complex tensor or CF (MG.h:110-121, 190-198)."""
    rows = []
    for i in range(vectors.shape[0]):
        v = vectors[i]
        for q in rows:
            v = v - q * dot(q, v)
        rows.append(normalize(v))
    if cplx.is_cf(vectors):
        return cplx.stack(rows, axis=0)
    return torch.stack(rows)
