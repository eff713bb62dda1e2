"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small and ragged lattices (site counts that are not a
multiple of the 256-thread block). Skips without a CUDA device. On the
card, without JAX installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    cplx,
    gcr_solve,
    gcr_solve_eager,
    links_from_numpy,
    setup_mg,
    with_link_dtype,
)
from mgpgcr_tpu_torch.kernels.dslash import dslash_apply, dslash_plain
from mgpgcr_tpu_torch.kernels.gcr_dslash import (
    gcr_stream_step,
    gcr_stream_step_plain,
    gcr_z_step,
    gcr_z_step_plain,
)
from mgpgcr_tpu_torch.kernels.gcr_kernels import (
    ap_update,
    ap_update_plain,
    basis_flush,
    basis_flush_plain,
    beta_dots,
    beta_dots_plain,
    dir_update,
    dir_update_plain,
    update_r,
    update_r_plain,
    update_xr,
    update_xr_plain,
)
from mgpgcr_tpu_torch.kernels.transfer import prolong, prolong_plain, restrict, restrict_plain
from mgpgcr_tpu_torch.ops import wilson

pytestmark = pytest.mark.cuda

LATTICES = [(4, 4, 4, 4), (2, 6, 3, 10), (6, 2, 5, 7)]
TOL = 1e-5  # f32 fields and reductions, relative to the output's scale


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    g = cplx.to_numpy(got) if cplx.is_cf(got) else got.detach().cpu().numpy()
    w = cplx.to_numpy(want) if cplx.is_cf(want) else want.detach().cpu().numpy()
    np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max())


def _setup(dims, dev, rows, ldt):
    mesh = LatticeMesh((*dims, 4, 3))
    links = links_from_numpy(
        wilson.random_links_np(1, mesh), mesh, dev, compress=rows == 2, link_dtype=ldt
    )
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (4, 3, dims[0], dims[1], dims[2] * dims[3])
    return mesh, links, gen, shape


@pytest.mark.parametrize("dims", LATTICES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("rows,ldt", [(3, torch.float32), (2, torch.bfloat16)])
def test_dslash_kernel(dev, dims, rows, ldt):
    mesh, links, gen, shape = _setup(dims, dev, rows, ldt)
    psi = cplx.random(gen, shape, torch.float32, dev)
    k = torch.tensor(0.13 - 0.02j, dtype=torch.complex64, device=dev)
    for kk, anti in ((None, False), (k, True)):
        before = dslash_apply.launches
        _close(dslash_apply(links, psi, mesh, kk, anti), dslash_plain(links, psi, mesh, kk, anti))
        assert dslash_apply.launches == before + 1


@pytest.mark.parametrize("dims", LATTICES, ids=lambda d: "x".join(map(str, d)))
def test_gcr_kernels(dev, dims):
    S = 3
    mesh, links, gen, shape = _setup(dims, dev, 2, torch.float32)
    r = cplx.random(gen, shape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    alpha = torch.tensor(0.4 + 0.1j, dtype=torch.complex64, device=dev)
    k = torch.tensor(0.12, dtype=torch.complex64, device=dev)
    betas = torch.tensor([0.3 - 0.1j, -0.2 + 0.5j, 0.1j], dtype=torch.complex64, device=dev)
    for lim in range(1, S + 1):
        got = gcr_stream_step(links, r, aps, alpha, k, lim, mesh, anti_t=True)
        want = gcr_stream_step_plain(links, r, aps, alpha, k, lim, mesh, anti_t=True)
        for g, w in zip(got, want):
            _close(g, w)
        slot = lim % S
        got_aps, got_n = ap_update(r, aps.clone(), betas, slot, lim)
        want_aps, want_n = ap_update_plain(r, aps.clone(), betas, slot, lim)
        _close(got_aps, want_aps)
        _close(got_n, want_n)
        basis = [aps[m] for m in range(lim)] + [r]
        w = betas[: lim + 1] if lim < S else torch.cat([betas, betas[:1]])
        for g, ww in zip(basis_flush(r, basis, w, w.conj()),
                         basis_flush_plain(r, basis, w, w.conj())):
            _close(g, ww)


def test_wrappers_refuse_what_the_kernels_cannot_take(dev):
    mesh, links, gen, shape = _setup((4, 4, 4, 4), dev, 3, torch.float32)
    psi64 = cplx.random(gen, shape, torch.float64, dev)
    with pytest.raises(ValueError):
        dslash_apply(links, psi64, mesh)
    with pytest.raises(ValueError):
        dslash_apply(links, cplx.random(gen, shape, torch.float32, dev).to("cpu"), mesh)


# (lattice, block) of the MG kernels: the 8^4 size and a ragged one
MG_LATTICES = [((8, 8, 8, 8), 4), ((2, 6, 3, 10), (1, 3, 3, 5))]


@pytest.mark.parametrize("dims,block", MG_LATTICES, ids=lambda v: str(v))
def test_mg_kernels(dev, dims, block):
    S = 3
    mesh, links2, gen, shape = _setup(dims, dev, 2, torch.float32)
    links3 = links_from_numpy(wilson.random_links_np(1, mesh), mesh, dev,
                              link_dtype=torch.bfloat16)
    r = cplx.random(gen, shape, torch.float32, dev)
    z = cplx.random(gen, shape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    alpha = torch.tensor(0.4 + 0.1j, dtype=torch.complex64, device=dev)
    k = torch.tensor(0.12, dtype=torch.complex64, device=dev)
    for slot in range(S):
        for g, w in zip(update_r(r, aps, slot, alpha), update_r_plain(r, aps, slot, alpha)):
            _close(g, w)
    for links in (links2, links3):
        for lim in range(1, S + 1):
            got = gcr_z_step(links, z, r, aps, k, lim, mesh, anti_t=True)
            want = gcr_z_step_plain(links, z, r, aps, k, lim, mesh, anti_t=True)
            for g, w in zip(got, want):
                _close(g, w)
    bm = mesh.blocking(block)
    ne = 4
    q = cplx.random(gen, (ne,) + shape, torch.float32, dev)
    xc = cplx.random(gen, (bm.n_blocks * ne,), torch.float32, dev)
    for qf in (q, q.astype(torch.bfloat16)):
        before = (restrict.launches, prolong.launches)
        _close(restrict(qf, bm, r), restrict_plain(qf, bm, r))
        _close(prolong(qf, bm, xc), prolong_plain(qf, bm, xc))
        _close(prolong(qf, bm, xc, r, 0.7), prolong_plain(qf, bm, xc, r, 0.7))
        assert (restrict.launches, prolong.launches) == (before[0] + 1, before[1] + 2)


def test_mg_gcr_solve(dev):
    """MG setup and the fused preconditioned restart-5 solve at 8^4, with
    a bf16-link smoother, against the generic form on the same hierarchy."""
    mesh = LatticeMesh((8, 8, 8, 8, 4, 3))
    d = CudaWilsonDirac.build(wilson.random_links_np(3, mesh), mesh, compress=True,
                              antiperiodic_t=True, device=dev)
    a = DiracOperator(d, 0.12)
    a_smooth = DiracOperator(with_link_dtype(d, torch.bfloat16), 0.12)
    mgp = setup_mg(torch.Generator(device=dev).manual_seed(4), a, mesh,
                   MGParams(block=4, n_nullvecs=3), smoother_operator=a_smooth)
    b = cplx.random(torch.Generator(device=dev).manual_seed(5), d.field_shape, device=dev)
    its = {}
    for fused in (True, False):
        params = GCRParams(tol=1e-6, max_iter=100, restart=5, fused=fused, unroll="cycles")
        res = gcr_solve(a, b, params, precond=mgp.apply)
        rr = b - a.apply(res.x)
        assert res.converged
        assert float(torch.sqrt(cplx.abs2_sum(rr) / cplx.abs2_sum(b))) < 2e-6
        its[fused] = res.n_iters
    assert abs(its[True] - its[False]) <= 1


# the loop form's kernels at 8^4 and on a ragged lattice; S = 20 takes B3
# past one chunk of 8 rows and lim past 16
@pytest.mark.parametrize("dims", [(8, 8, 8, 8), (2, 6, 3, 10)], ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("S", [3, 20])
def test_loop_kernels(dev, dims, S):
    _, _, gen, shape = _setup(dims, dev, 2, torch.float32)
    x, r, z, az = (cplx.random(gen, shape, torch.float32, dev) for _ in range(4))
    ps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    alpha = torch.tensor(0.4 + 0.1j, dtype=torch.complex64, device=dev)
    betas = torch.complex(torch.rand(S, generator=gen, device=dev),
                          torch.rand(S, generator=gen, device=dev)) - (0.5 + 0.5j)
    for slot in (0, S - 1):
        before = update_xr.launches
        for g, w in zip(update_xr(x, r, ps, aps, slot, alpha),
                        update_xr_plain(x, r, ps, aps, slot, alpha)):
            _close(g, w)
        assert update_xr.launches == before + 1
    for lim in sorted({1, min(S, 8), min(S, 9), S}):
        got = beta_dots(aps, az, lim)
        _close(got, beta_dots_plain(aps, az, lim))
        assert bool((got[lim:] == 0).all())
    # the ring slot past the live prefix, and inside it (truncation)
    for rr in (None, r):
        for lim, slot in ((S - 1, S - 1), (S, 1)):
            got = dir_update(z, az, rr, ps.clone(), aps.clone(), betas, slot, lim)
            want = dir_update_plain(z, az, rr, ps.clone(), aps.clone(), betas, slot, lim)
            for g, w in zip(got, want):
                _close(g, w)
    for lim, slot in ((S - 1, S - 1), (S, 0)):
        got = ap_update(az, aps.clone(), betas, slot, lim, r=r)
        want = ap_update_plain(az, aps.clone(), betas, slot, lim, r=r)
        for g, w in zip(got, want):
            _close(g, w)


def test_loop_form_solves(dev):
    """The fused loop form (restart with unroll="loop", truncation,
    residual refresh, restart 20), the fused eager form and the
    preconditioned cycles form on an odd t extent (beta_dots and the r form
    of ap_update) at small size: each converges, and the forms' kernels
    launched."""
    def problem(dims):
        mesh = LatticeMesh((*dims, 4, 3))
        d = CudaWilsonDirac.build(wilson.random_links_np(3, mesh), mesh, compress=True,
                                  antiperiodic_t=True, device=dev)
        b = cplx.random(torch.Generator(device=dev).manual_seed(5), d.field_shape, device=dev)
        return DiracOperator(d, 0.12), b

    def relres(a, b, x):
        rr = b - a.apply(x)
        return float(torch.sqrt(cplx.abs2_sum(rr) / cplx.abs2_sum(b)))

    a, b = problem((8, 8, 8, 8))
    base = dict(tol=1e-6, max_iter=200)
    ref = gcr_solve(a, b, GCRParams(restart=5, **base))
    for kw in (dict(restart=5, unroll="loop"), dict(truncation=5),
               dict(restart=5, residual_refresh=10), dict(restart=20)):
        before = (update_xr.launches, beta_dots.launches, dir_update.launches)
        res = gcr_solve(a, b, GCRParams(fused=True, **base, **kw))
        assert res.converged and relres(a, b, res.x) < 2e-6
        assert update_xr.launches > before[0] and beta_dots.launches > before[1]
        assert dir_update.launches > before[2]
        if kw.get("restart") == 5:
            assert abs(res.n_iters - ref.n_iters) <= 2
    res = gcr_solve_eager(a, b, GCRParams(fused=True, restart=5, **base), check_every=4)
    assert res.converged and relres(a, b, res.x) < 2e-6
    assert ref.n_iters - 2 <= res.n_iters <= ref.n_iters + 5

    # preconditioned, odd t: no z-step (the identity stands for M)
    a, b = problem((3, 4, 4, 8))
    before = (ap_update.launches, beta_dots.launches, update_r.launches)
    res = gcr_solve(a, b, GCRParams(fused=True, restart=5, unroll="cycles", **base),
                    precond=lambda v: v)
    assert res.converged and relres(a, b, res.x) < 2e-6
    assert ap_update.launches > before[0] and beta_dots.launches > before[1]
    assert update_r.launches > before[2]
