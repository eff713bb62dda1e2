"""The inputs of every cell, made by the benchmark from the seed: the
gauge field, its random gauge transforms, and the right-hand sides. The
program receives only these. Layouts: canonical links (4, T, Z, Y, X, 3,
3) as an (re, im) pair of float32 tensors; right-hand sides in the
program's slab layout (4, 3, T, Z, Y*X) as (re, im) float32 tensors."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def load_links(field: dict, dims, root: Path, device, seed: int):
    """Canonical float32 links on ``device``: the ``file`` (an .npz with
    ``re`` and ``im``) tiled ``tile`` times per axis, or, with ``haar``,
    Haar-random SU(3) links drawn from the seed (small test lattices)."""
    if "file" in field:
        with np.load(root / field["file"]) as f:
            re, im = f["re"], f["im"]
        reps = (1, *field.get("tile", (1, 1, 1, 1)), 1, 1)
        re = torch.as_tensor(re).to(device).repeat(reps)
        im = torch.as_tensor(im).to(device).repeat(reps)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        u = haar_su3(gen, (4, *dims), device)
        re, im = u.real.float(), u.imag.float()
    if tuple(re.shape[1:5]) != tuple(dims):
        raise ValueError(f"field has sites {tuple(re.shape[1:5])}, the lattice is {tuple(dims)}")
    return re.contiguous(), im.contiguous()


def haar_su3(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Haar-random SU(3) matrices of ``shape`` + (3, 3), complex128: rows 0
    and 1 by Gram--Schmidt of two complex Gaussian vectors, row 2 =
    conj(row0 x row1), so det = 1. Elementwise work only."""
    def gauss():
        return torch.complex(
            torch.randn((*shape, 3), generator=gen, dtype=torch.float64, device=device),
            torch.randn((*shape, 3), generator=gen, dtype=torch.float64, device=device))

    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    r0 = unit(gauss())
    z = gauss()
    r1 = unit(z - (r0.conj() * z).sum(-1, keepdim=True) * r0)
    r2 = torch.linalg.cross(r0, r1).conj()
    return torch.stack([r0, r1, r2], dim=-2)


def gauge_transform(links, gen: torch.Generator):
    """U'_mu(x) = g(x) U_mu(x) g(x + mu)^dag for Haar-random g: the same
    spectrum, other numbers. (re, im) float32 in and out; the product is
    taken in complex128 and rounded once."""
    re, im = links
    u = torch.complex(re.double(), im.double())
    g = haar_su3(gen, u.shape[1:5], u.device)
    out = torch.empty_like(u)
    for mu in range(4):
        g_fwd = torch.roll(g, -1, mu)
        out[mu] = g @ u[mu] @ g_fwd.conj().transpose(-1, -2)
    return out.real.float().contiguous(), out.imag.float().contiguous()


def noise_source(gen: torch.Generator, dims, device):
    """Complex Gaussian noise, re and im ~ N(0, 1), slab layout."""
    t, z, y, x = dims
    shape = (4, 3, t, z, y * x)
    return (torch.randn(shape, generator=gen, device=device),
            torch.randn(shape, generator=gen, device=device))


def point_source(dims, site, spin: int, colour: int, device):
    """The unit vector at ``site`` = (t, z, y, x), ``spin``, ``colour``."""
    t, z, y, x = dims
    re = torch.zeros((4, 3, t, z, y * x), device=device)
    re[spin, colour, site[0], site[1], site[2] * x + site[3]] = 1.0
    return re, torch.zeros_like(re)


def slab_to_lattice(re, im, dims) -> torch.Tensor:
    """Slab (4, 3, T, Z, Y*X) -> canonical (T, Z, Y, X, 4, 3), complex128."""
    t, z, y, x = dims
    c = torch.complex(re.double(), im.double()).reshape(4, 3, t, z, y, x)
    return c.permute(2, 3, 4, 5, 0, 1)


def lattice_to_flat(psi: torch.Tensor) -> torch.Tensor:
    """Canonical (T, Z, Y, X, 4, 3) -> flat (N,), index ((site*4 + spin)*3
    + colour), sites row-major in (t, z, y, x)."""
    return psi.contiguous().reshape(-1)


def flat_to_lattice(flat, dims) -> torch.Tensor:
    return torch.as_tensor(flat).reshape(*dims, 4, 3)
