"""A = I - k D, the Wilson--Dirac operator, in plain PyTorch complex128.

    D psi(x) = sum_mu [ (1 - gamma_mu) U_mu(x) psi(x + mu)
                      + (1 + gamma_mu) U_mu(x - mu)^dag psi(x - mu) ]

in the Dirac basis of the upstream solver (jing2li/MGPreconditionedGCR,
Operator.h; its gamma_5 swaps spinors 0<->2 and 1<->3):
gamma_t = diag(1, 1, -1, -1), gamma_i = [[0, -i sigma_i], [i sigma_i, 0]]
with sigma_3 on z, sigma_2 on y and sigma_1 on x, dims ordered (t, z, y, x).
With ``antiperiodic_t`` every hop across the t = T-1 | 0 face takes the
sign -1. Links are (4, T, Z, Y, X, 3, 3) and fields (T, Z, Y, X, 4, 3),
both complex. Written from the formula above, not from the program.
"""

from __future__ import annotations

import torch

_S = {
    1: ((0, 1), (1, 0)),
    2: ((0, -1j), (1j, 0)),
    3: ((1, 0), (0, -1)),
}


def gammas(device=None, dtype=torch.complex128) -> torch.Tensor:
    """(4, 4, 4): gamma_t, gamma_z, gamma_y, gamma_x."""
    g = torch.zeros(4, 4, 4, dtype=dtype, device=device)
    g[0] = torch.diag(torch.tensor([1, 1, -1, -1], dtype=dtype))
    for mu, k in ((1, 3), (2, 2), (3, 1)):
        s = torch.tensor(_S[k], dtype=dtype)
        g[mu, :2, 2:] = -1j * s
        g[mu, 2:, :2] = 1j * s
    return g


def _hop(u: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """U psi per site: (..., 3, 3) x (..., 4, 3) -> (..., 4, 3)."""
    return torch.einsum("tzyxab,tzyxsb->tzyxsa", u, psi)


def _spin(p: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ij,tzyxjc->tzyxic", p, psi)


def hopping(links: torch.Tensor, psi: torch.Tensor, antiperiodic_t: bool = True) -> torch.Tensor:
    """D psi."""
    g = gammas(psi.device, psi.dtype)
    one = torch.eye(4, dtype=psi.dtype, device=psi.device)
    u_all = links.to(psi.dtype)
    out = torch.zeros_like(psi)
    for mu in range(4):
        fwd = torch.roll(psi, -1, mu)
        bwd = torch.roll(psi, 1, mu)
        if mu == 0 and antiperiodic_t:
            fwd[-1] = -fwd[-1]
            bwd[0] = -bwd[0]
        u = u_all[mu]
        udag = torch.roll(u.conj().transpose(-1, -2), 1, mu)
        out += _spin(one - g[mu], _hop(u, fwd))
        out += _spin(one + g[mu], _hop(udag, bwd))
    return out


def dirac(links: torch.Tensor, psi: torch.Tensor, k: float, antiperiodic_t: bool = True):
    """A psi = psi - k D psi."""
    return psi - k * hopping(links, psi, antiperiodic_t)


def relative_residual(links, k: float, b: torch.Tensor, x: torch.Tensor,
                      antiperiodic_t: bool = True, dtype=torch.complex128) -> float:
    """||b - A x|| / ||b||, everything cast to ``dtype`` first."""
    b = b.to(dtype)
    r = b - dirac(links.to(dtype), x.to(dtype), k, antiperiodic_t)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
