"""Field algebra: inner products, norms and random fields.

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
