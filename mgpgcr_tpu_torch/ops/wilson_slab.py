"""Wilson--Dirac hopping stencil on slab-layout fields, in plain PyTorch.

Counterpart of ``mgpgcr_tpu/ops/wilson_tpu.py``. Fields are split re/im
``CF`` pairs in the layout ``(4, 3, T, Z, Y*X)`` (spin, colour, sites with
the merged y*x axis fastest); links are mu-major ``(4, 3, 3, T, Z, Y*X)``.
Neighbour access is ``torch.roll``: t and z are rolls of outer axes, y a
roll of the merged axis by X, x two rolls blended by a boundary mask.

``SlabWilsonDirac.apply`` is the plain version of the Dslash kernel
(``kernels/dslash.py``): the wrapper runs it for CPU tensors, the tests
hold it against the JAX package, and ``chip_smoke.py`` holds the kernel
against it on the card.

The spin algebra uses the half-spinor trick: (1 -+ gamma_mu) has rank 2,
so a hop projects psi to two spin components before the SU(3) colour
multiply and reconstructs after. In the Dirac basis every coefficient is
+-1 or +-i. With gamma_mu = [[0, A], [A^H, 0]] (A = -i sigma_mu):
  (1 - gamma_mu) psi = (h, -A^H h) with h = psi' - A psi''
  (1 + gamma_mu) psi = (h, +A^H h) with h = psi' + A psi''
(psi' = spins 0,1; psi'' = spins 2,3); the temporal projectors are
diag(0,0,2,2) forward and diag(2,2,0,0) backward.
"""

from __future__ import annotations

import dataclasses

import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import LinearOperator

# spatial table: mu (1=z, 2=y, 3=x) -> (j0, c0, j1, c1, k2, r2, k3, r3) for
# the forward factor (1 - gamma_mu):
#   h0 = psi0 + c0 psi_{j0},  h1 = psi1 + c1 psi_{j1}
#   out2 += r2 g_{k2},        out3 += r3 g_{k3}         (g = U . h)
# the backward factor (1 + gamma_mu) flips the sign of every coefficient.
_J = 1j
HALF_SPINOR = {
    1: (2, _J, 3, -_J, 0, -_J, 1, _J),
    2: (3, 1, 2, -1, 1, -1, 0, 1),
    3: (3, _J, 2, _J, 1, -_J, 0, -_J),
}


def add_unit(a, c, b: cplx.CF) -> cplx.CF:
    """a + c b for a unit coefficient c in {1, -1, i, -i}; a may be None."""
    if c == 1:
        term = b
    elif c == -1:
        term = -b
    elif c == _J:
        term = cplx.CF(-b.im, b.re)
    else:
        term = cplx.CF(b.im, -b.re)
    return term if a is None else a + term


def add_scaled(a, s: float, b: cplx.CF) -> cplx.CF:
    """a + s b for a real scalar s; a may be None."""
    term = cplx.scale_real(b, s)
    return term if a is None else a + term


def project_half(psi_slabs: list, mu: int, fwd: bool) -> list:
    """(1 -+ gamma_mu) psi -> the independent half spinor [h0, h1]."""
    if mu == 0:
        lo = 2 if fwd else 0
        return [psi_slabs[lo], psi_slabs[lo + 1]]
    j0, c0, j1, c1, _, _, _, _ = HALF_SPINOR[mu]
    if not fwd:
        c0, c1 = -c0, -c1
    return [
        add_unit(psi_slabs[0], c0, psi_slabs[j0]),
        add_unit(psi_slabs[1], c1, psi_slabs[j1]),
    ]


def accumulate_half(out: list, g: list, mu: int, fwd: bool) -> list:
    """out += the hop's 4-spin reconstruction from g = U^(H) . h."""
    if mu == 0:
        base = 2 if fwd else 0
        out[base] = add_scaled(out[base], 2.0, g[0])
        out[base + 1] = add_scaled(out[base + 1], 2.0, g[1])
        return out
    _, _, _, _, k2, r2, k3, r3 = HALF_SPINOR[mu]
    if not fwd:
        r2, r3 = -r2, -r3
    out[0] = g[0] if out[0] is None else out[0] + g[0]
    out[1] = g[1] if out[1] is None else out[1] + g[1]
    out[2] = add_unit(out[2], r2, g[k2])
    out[3] = add_unit(out[3], r3, g[k3])
    return out


def colour_mul(u: cplx.CF, slabs: list, dagger: bool) -> list:
    """Per spin slab (3, ...): U . slab, or U^dag . slab; u is (3, 3, ...)."""
    out = []
    for ps in slabs:
        rows = []
        for a in range(3):
            acc = None
            for b in range(3):
                term = (u[b, a].conj() if dagger else u[a, b]) * ps[b]
                acc = term if acc is None else acc + term
            rows.append(acc)
        out.append(cplx.stack(rows, axis=0))
    return out


def field_to_slab(x, mesh: LatticeMesh):
    """Canonical flat (..., N) or lattice (..., T, Z, Y, X, 4, 3) field ->
    slab layout (..., 4, 3, T, Z, Y*X); CF or complex tensor. Counterpart
    of ``field_to_tpu``."""
    t, z, y, xx = mesh.spacetime_dims
    nd = len(mesh.dims)
    if x.ndim < nd or x.shape[-1] != 3:
        x = mesh.to_lattice(x)
    lead = x.ndim - nd
    perm = tuple(range(lead)) + tuple(lead + a for a in (4, 5, 0, 1, 2, 3))
    xt = x.permute(perm)
    return xt.reshape(tuple(xt.shape[: lead + 4]) + (y * xx,))


def field_from_slab(x, mesh: LatticeMesh, flat: bool = True):
    """Slab layout (..., 4, 3, T, Z, Y*X) -> canonical field. Counterpart
    of ``field_from_tpu``."""
    t, z, y, xx = mesh.spacetime_dims
    lead = x.ndim - 5
    xs = x.reshape(tuple(x.shape[:-1]) + (y, xx))
    perm = tuple(range(lead)) + tuple(lead + a for a in (2, 3, 4, 5, 0, 1))
    xc = xs.permute(perm)
    return mesh.to_flat(xc) if flat else xc


def links_to_slab(links: cplx.CF, mesh: LatticeMesh) -> cplx.CF:
    """(4, T, Z, Y, X, 3, 3) canonical links -> mu-major (4, 3, 3, T, Z, Y*X).
    Counterpart of ``links_to_tpu``."""
    t, z, y, xx = mesh.spacetime_dims
    lt = links.permute(0, 5, 6, 1, 2, 3, 4)
    return lt.reshape((4, 3, 3, t, z, y * xx)).contiguous()


def with_link_dtype(op, dtype):
    """Copy of a Wilson operator with its link storage cast (e.g.
    ``torch.bfloat16``); arithmetic stays in the field dtype."""
    return dataclasses.replace(op, links=op.links.astype(dtype))


def gamma5_slab(x: cplx.CF) -> cplx.CF:
    """gamma_5 on slab fields (..., 4, 3, T, Z, Y*X): spin swap 0<->2, 1<->3."""
    return cplx.take(x, [2, 3, 0, 1], axis=x.ndim - 5)


def shift(v: cplx.CF, mu: int, fwd: bool, xx: int) -> cplx.CF:
    """Value at the +-mu neighbour, periodic; v is (..., T, Z, Y*X)."""
    s = -1 if fwd else 1
    if mu == 0:
        return cplx.roll(v, s, v.ndim - 3)
    if mu == 1:
        return cplx.roll(v, s, v.ndim - 2)
    ax = v.ndim - 1
    if mu == 2:
        return cplx.roll(v, s * xx, ax)
    xcoord = torch.arange(v.shape[-1], device=v.device) % xx
    if fwd:  # psi(x+1): roll -1, except x == X-1 wraps to x = 0
        return cplx.where(xcoord == xx - 1, cplx.roll(v, xx - 1, ax), cplx.roll(v, -1, ax))
    return cplx.where(xcoord == 0, cplx.roll(v, -(xx - 1), ax), cplx.roll(v, 1, ax))


def slab_dslash(links: cplx.CF, psi: cplx.CF, xx: int) -> cplx.CF:
    """D psi on slab fields with mu-major (4, 3, 3, T, Z, Y*X) links in the
    field dtype; ``xx`` is the lattice X extent. The backward hop shifts
    the product U^dag psi (colour multiplication commutes with the shift)."""
    psi_slabs = [psi[s] for s in range(4)]
    out = [None] * 4
    for mu in range(4):
        h = [shift(hq, mu, True, xx) for hq in project_half(psi_slabs, mu, True)]
        out = accumulate_half(out, colour_mul(links[mu], h, dagger=False), mu, True)
        w = colour_mul(links[mu], project_half(psi_slabs, mu, False), dagger=True)
        w = [shift(wq, mu, False, xx) for wq in w]
        out = accumulate_half(out, w, mu, False)
    return cplx.stack(out, axis=0)


@dataclasses.dataclass(frozen=True)
class SlabWilsonDirac(LinearOperator):
    """Matrix-free hopping operator D on slab fields, plain PyTorch
    (counterpart of ``TpuWilsonDirac``, single device). Pair with
    ``DiracOperator`` for A = I - kD."""

    links: cplx.CF  # (4, 3, 3, T, Z, Y*X)
    mesh: LatticeMesh

    @staticmethod
    def build(links_canonical: cplx.CF, mesh: LatticeMesh) -> "SlabWilsonDirac":
        return SlabWilsonDirac(links_to_slab(links_canonical, mesh), mesh)

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
        links = self.links.astype(psi.dtype)
        return slab_dslash(links, psi, self.mesh.spacetime_dims[3])
