"""One smoothed multigrid V-cycle in plain PyTorch complex128:

    x  = GCR_s(A, r)                          pre-smooth from x = 0
    x += P GCR_c(P^H A P, P^H (r - A x))      coarse correction
    x  = GCR_s(A, r, x0 = x)                  post-smooth

A is ``wilson.dirac``; P is built by blocks from a given basis (input
data, as a model's weights): block B's columns are the basis vectors
restricted to B's sites, so P^H v is every block's dots with them and P c
sums them weighted by c. The coarse operator is applied as P^H A P,
never assembled, so that it fits at 32^4. GCR_s and GCR_c are restarted
GCR without a preconditioner, run for a fixed number of iterations: the
program stops its coarse GCR on a tolerance, and the comparison gives
this side the count the program took. Fields are (T, Z, Y, X, 4, 3) and
the basis (ne, T, Z, Y, X, 4, 3), complex. Written from the formulas
above, not from the program.

Departures from the upstream ``MG::solve`` (MGPreconditionedGCR,
MG.h:406-430), which are the program's too:
- the post-smooth starts from the corrected x; upstream overwrites x with
  a smooth of the right-hand side from zero (MG.h:429), which drops the
  pre-smooth and the coarse correction;
- the coarse right-hand side is the restricted residual r - A x of the
  pre-smoothed x, not the restricted r (MG.h:418);
- the correction is added undamped; upstream scales it by 0.1 (MG.h:426);
- the result is returned; upstream's ``solve`` takes x by value (MG.h:406);
- the -mu coarse couplings use the -mu neighbour's basis (upstream reuses
  the +mu one's, MG.h:263), which P^H A P gives by construction.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference import wilson


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32, not TF32, for the block; restored after."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def blocked(psi: torch.Tensor, block: int) -> torch.Tensor:
    """(..., T, Z, Y, X, 4, 3) -> (..., n_blocks, block sites * 12), blocks
    row-major in (t, z, y, x), sites row-major within a block."""
    lead = psi.shape[:-6]
    t, z, y, x = psi.shape[-6:-2]
    n = len(lead)
    v = psi.reshape(*lead, t // block, block, z // block, block, y // block, block,
                    x // block, block, 12)
    v = v.permute(*range(n), *(n + i for i in (0, 2, 4, 6, 1, 3, 5, 7, 8)))
    return v.reshape(*lead, (t * z * y * x) // block**4, block**4 * 12)


def unblocked(vb: torch.Tensor, dims, block: int) -> torch.Tensor:
    """The inverse of ``blocked`` for one field: (n_blocks, block_len) ->
    (T, Z, Y, X, 4, 3)."""
    t, z, y, x = dims
    v = vb.reshape(t // block, z // block, y // block, x // block, block, block, block, block,
                   12)
    return v.permute(0, 4, 1, 5, 2, 6, 3, 7, 8).reshape(t, z, y, x, 4, 3)


class Transfer:
    """P and P^H of a basis (ne, T, Z, Y, X, 4, 3) on blocks of ``block``^4
    sites; coarse vectors are (n_blocks, ne)."""

    def __init__(self, basis: torch.Tensor, block: int):
        self.dims, self.block = tuple(basis.shape[1:5]), block
        self.q = blocked(basis, block)  # (ne, n_blocks, block_len)

    def restrict(self, v: torch.Tensor) -> torch.Tensor:
        # conj(sum q conj(v)) = sum conj(q) v, without a conjugated copy of q
        return torch.einsum("ebk,bk->be", self.q, blocked(v, self.block).conj()).conj()

    def prolong(self, c: torch.Tensor) -> torch.Tensor:
        return unblocked(torch.einsum("ebk,be->bk", self.q, c), self.dims, self.block)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> = sum conj(a) b."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def gcr(apply, b: torch.Tensor, iterations: int, restart: int, x0=None) -> torch.Tensor:
    """``iterations`` steps of restarted GCR on A x = b from x0 (zero when
    None): alpha = <Ap, r> / <Ap, Ap> of the newest direction, the next
    direction r - sum_j beta_j p_j with beta_j = <Ap_j, Ar> / <Ap_j, Ap_j>
    over the directions held, which are dropped after every ``restart``
    steps (the first direction after a drop is still made orthogonal to
    the dropped ones, as in GCR.h:222-288)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b.clone() if x0 is None else b - apply(x)
    p, ap = r.clone(), apply(r)
    ps, aps = [p], [ap]
    for it in range(1, iterations + 1):
        alpha = _dot(ap, r) / _dot(ap, ap).real
        x = x + alpha * p
        r = r - alpha * ap
        if it == iterations:
            break
        ar = apply(r)
        betas = [_dot(apj, ar) / _dot(apj, apj).real for apj in aps]
        p = r - sum(bj * pj for bj, pj in zip(betas, ps))
        ap = ar - sum(bj * apj for bj, apj in zip(betas, aps))
        if it % restart == 0:
            ps, aps = [], []
        ps.append(p)
        aps.append(ap)
    return x


def vcycle(links: torch.Tensor, k: float, transfer: Transfer, r: torch.Tensor,
           coarse_iterations: int, coarse_restart: int = 10, smooth_iterations: int = 4,
           smooth_restart: int = 4, n_pre: int = 1, n_post: int = 1,
           antiperiodic_t: bool = True) -> torch.Tensor:
    """x ~ A^-1 r by one V(n_pre, n_post)-cycle, in complex128."""
    with no_tf32():
        links, r = links.to(torch.complex128), r.to(torch.complex128)

        def a(v):
            return wilson.dirac(links, v, k, antiperiodic_t)

        def coarse(c):
            return transfer.restrict(a(transfer.prolong(c)))

        x = None
        for _ in range(n_pre):
            x = gcr(a, r, smooth_iterations, smooth_restart, x0=x)
        x = torch.zeros_like(r) if x is None else x
        rc = transfer.restrict(r - a(x))
        x = x + transfer.prolong(gcr(coarse, rc, coarse_iterations, coarse_restart))
        for _ in range(n_post):
            x = gcr(a, r, smooth_iterations, smooth_restart, x0=x)
        return x
