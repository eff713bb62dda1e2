"""Quenched SU(3) gauge-configuration generator (Wilson plaquette action).

Counterpart of ``mgpgcr_tpu/gauge.py`` and ``mgpgcr_tpu/gauge_tpu.py`` in
one module. The reference's hopping matrices come from thermalised
Monte-Carlo configurations (Parse.cpp:13, main.cpp:837); this generates
them: a Cabibbo--Marinari pseudo-heat bath (Kennedy--Pendleton SU(2)
subgroup sampling) and SU(2)-subgroup overrelaxation for

    S = -(beta/3) sum_{x, mu<nu} Re tr U_mu(x) U_nu(x+mu) U_mu(x+nu)^H U_nu(x)^H.

One complex implementation in the canonical layout ``(4, T, Z, Y, X, 3,
3)`` (complex64 on the card, complex128 for exact checks) replaces the JAX
package's complex form and its split re/im colour-major TPU form:
lattice-wide batched 3x3 products (``torch.matmul``, as the JAX forms
leave them to XLA; no kernel of the port) and ``torch.roll`` shifts.
Even-odd checkerboarding makes every update site-independent: the staple
of U_mu(x) involves same-direction links only at x +- nu, of opposite
parity, so a (mu, parity) sublattice updates at once.

Randomness comes from an explicit ``torch.Generator``; ``sweep`` takes an
optional ``sampler(mu, parity, subgroup, alpha) -> SU(2) field`` in its
place (the tests replay the JAX package's draws through it). Validation
anchor: the average plaquette at beta = 6.0 is 0.5937.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh

_SUBGROUPS = ((0, 1), (0, 2), (1, 2))
KP_TRIES = 60  # masked Kennedy--Pendleton tries per draw
KP_CHECK_EVERY = 8  # tries between the host's checks for all sites accepted


def _roll(u: torch.Tensor, mu: int, shift: int) -> torch.Tensor:
    """Shift a (..., T, Z, Y, X, 3, 3) lattice tensor along direction mu:
    shift = -1 gives f(x + mu), +1 gives f(x - mu) (periodic)."""
    return torch.roll(u, shift, mu - 6)


def _dag(u: torch.Tensor) -> torch.Tensor:
    return u.conj().transpose(-1, -2)


def staples(links: torch.Tensor, mu: int) -> torch.Tensor:
    """The sum A(x) of the 6 staples coupling to U_mu(x); the local action
    is -(beta/3) Re tr(U_mu(x) A(x)). links: (4, T, Z, Y, X, 3, 3)."""
    u_mu = links[mu]
    acc = None
    for nu in range(4):
        if nu == mu:
            continue
        u_nu = links[nu]
        # up: U_nu(x+mu) U_mu(x+nu)^H U_nu(x)^H
        up = _roll(u_nu, mu, -1) @ _dag(_roll(u_mu, nu, -1)) @ _dag(u_nu)
        # down: U_nu(x+mu-nu)^H U_mu(x-nu)^H U_nu(x-nu)
        u_nu_dn = _roll(u_nu, nu, 1)
        down = _dag(_roll(u_nu_dn, mu, -1)) @ _dag(_roll(u_mu, nu, 1)) @ u_nu_dn
        acc = up + down if acc is None else acc + up + down
    return acc


def plaquette(links: torch.Tensor) -> float:
    """Average (1/3) Re tr over the 6 oriented plaquettes per site."""
    tot = 0.0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            p = (links[mu] @ _roll(links[nu], mu, -1) @ _dag(_roll(links[mu], nu, -1))
                 @ _dag(links[nu]))
            tot = tot + torch.diagonal(p, dim1=-2, dim2=-1).sum(-1).real.mean() / 3.0
    return float(tot / 6)


def parity_mask(spacetime_dims, parity: int, device=None) -> torch.Tensor:
    """Bool (T, Z, Y, X): True on the sites of ``parity``."""
    grids = np.indices(tuple(spacetime_dims))
    return torch.as_tensor((grids.sum(axis=0) % 2) == parity).to(device)


def quat_to_su2(h0, h1, h2, h3, cdt) -> torch.Tensor:
    """(h0 + i h.sigma) as a (..., 2, 2) complex matrix."""
    row0 = torch.stack([torch.complex(h0, h3), torch.complex(h2, h1)], -1)
    row1 = torch.stack([torch.complex(-h2, h1), torch.complex(h0, -h3)], -1)
    return torch.stack([row0, row1], -2).to(cdt)


def _w_quaternion(w: torch.Tensor, i: int, j: int):
    """Quaternion components of the SU(2)-span part of the (i, j) 2x2
    submatrix of w: Re tr(g w_sub) = 2 (g0 x0 - g.x) sees only these."""
    w00, w01, w10, w11 = w[..., i, i], w[..., i, j], w[..., j, i], w[..., j, j]
    x0 = (w00.real + w11.real) * 0.5
    x1 = (w01.imag + w10.imag) * 0.5
    x2 = (w01.real - w10.real) * 0.5
    x3 = (w00.imag - w11.imag) * 0.5
    return x0, x1, x2, x3


def kp_sample(generator: torch.Generator, alpha: torch.Tensor, n_tries: int = KP_TRIES):
    """Kennedy--Pendleton: h0 on [-1, 1] with density ~ sqrt(1 - h0^2)
    exp(2 alpha h0), vectorised with masked rejection tries; a site still
    unaccepted after ``n_tries`` keeps its last proposal (probability under
    1e-9 per site at production beta). Stops early once every site is
    accepted, checked every ``KP_CHECK_EVERY`` tries (each check waits on
    the host): later tries would change nothing. Returns (h0, accepted)."""
    rdt, shape, dev = alpha.dtype, alpha.shape, alpha.device
    # h0 = 1 - 2 lambda^2; lambda^2 ~ Gamma(3/2, rate 4 alpha) before the
    # sqrt(1 - lambda^2) rejection: Exp(4a) + cos^2 * Exp(4a)
    a = torch.clamp(4.0 * alpha, min=1e-12)
    eps = 1e-12
    h0 = torch.zeros(shape, dtype=rdt, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)

    def uniform(lo):
        u = torch.rand(shape, generator=generator, dtype=rdt, device=dev)
        return lo + (1.0 - lo) * u

    for t in range(n_tries):
        r1, r2, r3, r4 = uniform(eps), uniform(0.0), uniform(eps), uniform(0.0)
        lam2 = -(torch.log(r1) + torch.cos(2 * math.pi * r2) ** 2 * torch.log(r3)) / a
        accept = r4 * r4 <= 1.0 - lam2
        h0 = torch.where(accept & ~done, 1.0 - 2.0 * lam2, h0)
        done = done | accept
        if (t + 1) % KP_CHECK_EVERY == 0 and bool(done.all()):
            break
    return torch.clamp(h0, -1.0, 1.0), done


def random_su2_from_h0(generator: torch.Generator, h0: torch.Tensor, cdt) -> torch.Tensor:
    """Complete h0 into an SU(2) element with a Haar-random direction."""
    n = torch.randn(tuple(h0.shape) + (3,), generator=generator, dtype=h0.dtype,
                    device=h0.device)
    n = n / torch.clamp(torch.sqrt(torch.sum(n * n, -1, keepdim=True)), min=1e-30)
    s = torch.sqrt(torch.clamp(1.0 - h0 * h0, min=0.0))
    return quat_to_su2(h0, s * n[..., 0], s * n[..., 1], s * n[..., 2], cdt)


def generator_sampler(generator: torch.Generator):
    """The default ``sampler`` of :func:`sweep`: a Kennedy--Pendleton h0
    and a random direction, both drawn from ``generator``."""

    def sample(mu: int, parity: int, subgroup: int, alpha: torch.Tensor) -> torch.Tensor:
        h0, _ = kp_sample(generator, alpha)
        return random_su2_from_h0(generator, h0, cplx.complex_dtype(alpha.dtype))

    return sample


def _apply_subgroup(u: torch.Tensor, g: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """U' = embed_ij(g) U: rows i and j of U mixed by the 2x2 g."""
    ri = g[..., 0, 0, None] * u[..., i, :] + g[..., 0, 1, None] * u[..., j, :]
    rj = g[..., 1, 0, None] * u[..., i, :] + g[..., 1, 1, None] * u[..., j, :]
    out = u.clone()
    out[..., i, :] = ri
    out[..., j, :] = rj
    return out


def _subgroup_v(w: torch.Tensor, i: int, j: int):
    """(xi, V): the SU(2)-span part of w_sub is xi V, V in SU(2)."""
    x0, x1, x2, x3 = _w_quaternion(w, i, j)
    xi = torch.sqrt(x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3)
    inv = 1.0 / torch.clamp(xi, min=1e-30)
    return xi, quat_to_su2(x0 * inv, x1 * inv, x2 * inv, x3 * inv, w.dtype)


def _heatbath_mu_parity(links, mu: int, parity: int, mask, beta: float, sampler):
    """One (mu, parity) sublattice pseudo-heat-bath update, in place."""
    a = staples(links, mu)
    u = links[mu]
    for idx, (i, j) in enumerate(_SUBGROUPS):
        xi, v = _subgroup_v(u @ a, i, j)
        h = sampler(mu, parity, idx, (beta / 3.0) * xi).to(u.device, u.dtype)
        u = _apply_subgroup(u, h @ _dag(v), i, j)
    links[mu] = torch.where(mask[..., None, None], u, links[mu])


def _overrelax_mu_parity(links, mu: int, mask):
    """One (mu, parity) sublattice microcanonical overrelaxation, in place:
    each SU(2) subgroup reflects to (V^H)^2, the action-preserving point
    farthest from the current element."""
    a = staples(links, mu)
    u = links[mu]
    for i, j in _SUBGROUPS:
        _, v = _subgroup_v(u @ a, i, j)
        vd = _dag(v)
        u = _apply_subgroup(u, vd @ vd, i, j)
    links[mu] = torch.where(mask[..., None, None], u, links[mu])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex 3-vector cross product along the last axis."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def reunitarize(links: torch.Tensor) -> torch.Tensor:
    """Project each link back to SU(3): Gram--Schmidt of rows 0 and 1, row
    2 = conj(row0 x row1). Removes the rounding drift of the sweeps and
    keeps the links two-row compressible."""
    r0 = links[..., 0, :]
    r0 = r0 / torch.linalg.vector_norm(r0, dim=-1, keepdim=True)
    r1 = links[..., 1, :]
    r1 = r1 - torch.sum(r0.conj() * r1, -1, keepdim=True) * r0
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    return torch.stack([r0, r1, _cross(r0, r1).conj()], -2)


def sweep(generator: torch.Generator | None, links: torch.Tensor, beta: float,
          n_or: int = 3, sampler=None) -> torch.Tensor:
    """One full lattice update: a pseudo-heat-bath sweep and ``n_or``
    overrelaxation sweeps (4 directions x 2 parities each), then
    re-unitarisation. ``links`` (4, T, Z, Y, X, 3, 3) complex is not
    changed; the draws come from ``sampler`` if given, else from
    ``generator`` (on the links' device)."""
    if sampler is None:
        sampler = generator_sampler(generator)
    links = links.clone()
    masks = [parity_mask(links.shape[1:5], p, links.device) for p in (0, 1)]
    for mu in range(4):
        for p in (0, 1):
            _heatbath_mu_parity(links, mu, p, masks[p], beta, sampler)
    for _ in range(n_or):
        for mu in range(4):
            for p in (0, 1):
                _overrelax_mu_parity(links, mu, masks[p])
    return reunitarize(links)


def unitarity_error(links: torch.Tensor) -> tuple[float, float]:
    """(max |U U^H - 1|, max |det U - 1|) over all links."""
    eye = torch.eye(3, dtype=links.dtype, device=links.device)
    unit = float((links @ _dag(links) - eye).abs().max())
    det = float((torch.linalg.det(links) - 1).abs().max())
    return unit, det


def thermalized_links(seed: int, mesh: LatticeMesh, beta: float = 6.0, n_sweeps: int = 100,
                      n_or: int = 3, dtype=torch.complex64, start: str = "hot",
                      measure_every: int = 10, device=None, on_progress=None):
    """Generate a quenched configuration on ``device`` (CUDA unless named).
    Returns (links, plaquette_history): canonical complex (4, T, Z, Y, X,
    3, 3) links of ``dtype``, and the plaquette every ``measure_every``
    sweeps and after the last. A hot start is the Haar-random
    ``random_links_np(seed, mesh)``; a cold start unit links; the sweeps
    draw from a generator seeded with ``seed``. ``on_progress(sweep_index,
    plaquette)`` runs at each measurement."""
    from mgpgcr_tpu_torch.ops.wilson import random_links_np

    dev = cplx.resolve_device(device)
    st = mesh.spacetime_dims
    if start == "cold":
        links = torch.eye(3, dtype=dtype, device=dev).expand(4, *st, 3, 3).clone()
    elif start == "hot":
        links = torch.as_tensor(random_links_np(seed, mesh)).to(dev, dtype)
    else:
        raise ValueError(f"start must be 'hot' or 'cold', not {start!r}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = []
    for s in range(n_sweeps):
        links = sweep(gen, links, beta, n_or)
        if (s + 1) % measure_every == 0 or s == n_sweeps - 1:
            hist.append(plaquette(links))
            if on_progress is not None:
                on_progress(s, hist[-1])
    return links, hist


def thermalized_links_cf(seed: int, mesh: LatticeMesh, beta: float = 6.0,
                         n_sweeps: int = 100, n_or: int = 3, dtype=torch.float32,
                         start: str = "hot", measure_every: int = 10, device=None,
                         on_progress=None):
    """:func:`thermalized_links` returning the links as a canonical split
    re/im CF of real ``dtype`` (4, T, Z, Y, X, 3, 3), the input of
    ``CudaWilsonDirac.build``. Sweeps run in the complex dtype of
    ``dtype``."""
    links, hist = thermalized_links(seed, mesh, beta, n_sweeps, n_or,
                                    cplx.complex_dtype(dtype), start, measure_every, device,
                                    on_progress)
    return cplx.CF(links.real.to(dtype).contiguous(), links.imag.to(dtype).contiguous()), hist
