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
from mgpgcr_tpu_torch.kernels.dslash import dslash_apply, dslash_mu, dslash_mu_plain, dslash_plain
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
from mgpgcr_tpu_torch.kernels.spmv import stencil_spmv, stencil_spmv_plain
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


# B12's grids: the config of record's coarse level (8^4, ne 20), the
# three-level cell's (ne 12 on 4^4 and 2^4 blocks, duplicate slots); nd 1
# to 4, extents 1 and 2 (duplicate slots), ne 3, 6 and 40 (not multiples of
# the 16-byte chunk, and past one warp of chunks), block-row counts that
# are not multiples of a CTA's output entries
SPMV_CASES = [((8, 8, 8, 8), 20), ((4, 4, 4, 4), 12), ((2, 2, 2, 2), 12), ((5,), 3),
              ((7,), 6), ((3, 1, 2), 40), ((2, 5), 6), ((1, 3, 2), 3), ((3, 2, 1, 5), 20),
              ((3, 5, 1), 12)]


def _offset_copy(t, off: int = 1):
    """A contiguous copy of ``t`` whose data starts ``off`` elements into its
    storage, so that no load wider than one element is aligned."""
    flat = torch.zeros(t.numel() + off, dtype=t.dtype, device=t.device)
    flat[off:] = t.reshape(-1)
    return flat[off:].view(t.shape)


@pytest.mark.parametrize("dims,ne", SPMV_CASES, ids=lambda v: str(v))
def test_stencil_spmv_kernel(dev, dims, ne):
    gen = torch.Generator(device=dev).manual_seed(6)
    nb = int(np.prod(dims))
    blocks = cplx.random(gen, (nb, 2 * len(dims) + 1, ne, ne), torch.float32, dev)
    x = cplx.random(gen, (nb * ne,), torch.float32, dev)
    xo = cplx.CF(_offset_copy(x.re), _offset_copy(x.im))
    for bl in (blocks, blocks.astype(torch.bfloat16)):
        want = stencil_spmv_plain(bl, x, dims)
        blo = cplx.CF(_offset_copy(bl.re), _offset_copy(bl.im))
        # aligned inputs take the widest loads; offset ones the scalar path
        for b_in, x_in in ((bl, x), (blo, xo), (bl, xo)):
            before = stencil_spmv.launches
            _close(stencil_spmv(b_in, x_in, dims), want)
            assert stencil_spmv.launches == before + 1
    with pytest.raises(ValueError):
        stencil_spmv(blocks, x.astype(torch.float64), dims)
    with pytest.raises(ValueError):
        stencil_spmv(blocks, x[: nb * ne - 1], dims)


# the one-pass steps' link storage: rows 2 and 3, f32 and bf16
STEP_LINKS = [(2, torch.float32), (3, torch.float32), (2, torch.bfloat16), (3, torch.bfloat16)]


@pytest.mark.parametrize("dims", [(4, 4, 4, 4), (2, 6, 3, 10)], ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("S", [5, 20])
@pytest.mark.parametrize("rows,ldt", STEP_LINKS, ids=lambda v: str(v))
def test_gcr_step_kernels(dev, dims, S, rows, ldt):
    """K2 and B9 at every lim from 1 to S (S = 20 stages more values than
    one warp tile holds) against their plain versions; the rows from lim on
    are zero."""
    mesh, links, gen, shape = _setup(dims, dev, rows, ldt)
    r = cplx.random(gen, shape, torch.float32, dev)
    z = cplx.random(gen, shape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    alpha = torch.tensor(0.4 + 0.1j, dtype=torch.complex64, device=dev)
    k = torch.tensor(0.12 - 0.03j, dtype=torch.complex64, device=dev)
    for lim in range(1, S + 1):
        got = gcr_stream_step(links, r, aps, alpha, k, lim, mesh, anti_t=True)
        want = gcr_stream_step_plain(links, r, aps, alpha, k, lim, mesh, anti_t=True)
        for g, w in zip(got, want):
            _close(g, w)
        assert bool((got[3][lim:] == 0).all()) and bool((got[4][lim:S] == 0).all())
        got = gcr_z_step(links, z, r, aps, k, lim, mesh, anti_t=True)
        want = gcr_z_step_plain(links, z, r, aps, k, lim, mesh, anti_t=True)
        for g, w in zip(got, want):
            _close(g, w)
        assert bool((got[1][lim:] == 0).all()) and bool((got[2][lim:S] == 0).all())


@pytest.mark.parametrize("dims", LATTICES, ids=lambda d: "x".join(map(str, d)))
def test_dslash_mu_kernel(dev, dims):
    """B13 on mu-major links against its plain version, and the mu-major
    operator (sign folded into the links) against K1 on 3-row t-major links
    with the in-kernel sign."""
    mesh = LatticeMesh((*dims, 4, 3))
    canon = wilson.random_links_np(1, mesh)
    gen = torch.Generator(device=dev).manual_seed(2)
    psi = cplx.random(gen, (4, 3, dims[0], dims[1], dims[2] * dims[3]), torch.float32, dev)
    k = torch.tensor(0.13 - 0.02j, dtype=torch.complex64, device=dev)
    tmajor = CudaWilsonDirac.build(canon, mesh, antiperiodic_t=True, device=dev)
    for ldt in (torch.float32, torch.bfloat16):
        mu = CudaWilsonDirac.build(canon, mesh, antiperiodic_t=True, device=dev, link_dtype=ldt,
                                   tb=1, zb=1)
        assert not mu.t_major
        for kk in (None, k):
            before = dslash_mu.launches
            _close(dslash_mu(mu.links, psi, mesh, kk), dslash_mu_plain(mu.links, psi, mesh, kk))
            assert dslash_mu.launches == before + 1
    mu = CudaWilsonDirac.build(canon, mesh, antiperiodic_t=True, device=dev, tb=1, zb=1)
    _close(mu.apply_dirac(psi, 0.12), tmajor.apply_dirac(psi, 0.12))


def test_mu_major_and_stencil_solves(dev):
    """The fused restart-5 solve on mu-major links (no one-pass step) and a
    two-level MG with the block-stencil coarse operator at 8^4: each
    converges, and B13 and B12 launched."""
    mesh = LatticeMesh((8, 8, 8, 8, 4, 3))
    canon = wilson.random_links_np(3, mesh)
    d = CudaWilsonDirac.build(canon, mesh, antiperiodic_t=True, device=dev, tb=2)
    a = DiracOperator(d, 0.12)
    b = cplx.random(torch.Generator(device=dev).manual_seed(5), d.field_shape, device=dev)
    before = (dslash_mu.launches, gcr_stream_step.launches)
    res = gcr_solve(a, b, GCRParams(tol=1e-6, max_iter=200, restart=5, fused=True))
    rr = b - a.apply(res.x)
    assert res.converged and float(torch.sqrt(cplx.abs2_sum(rr) / cplx.abs2_sum(b))) < 2e-6
    assert dslash_mu.launches > before[0] and gcr_stream_step.launches == before[1]

    t = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(t, 0.12)
    mgp = setup_mg(torch.Generator(device=dev).manual_seed(4), a, mesh,
                   MGParams(block=2, n_nullvecs=3, coarse_format="stencil", n_level=3))
    before = stencil_spmv.launches
    res = gcr_solve(a, b, GCRParams(tol=1e-6, max_iter=100, restart=5, fused=True),
                    precond=mgp.apply)
    rr = b - a.apply(res.x)
    assert res.converged and float(torch.sqrt(cplx.abs2_sum(rr) / cplx.abs2_sum(b))) < 2e-6
    assert stencil_spmv.launches > before and mgp.coarse_precond is not None


# the ghost-plane kernels on (t, z) grids of ThreadComm ranks sharing the
# card: a ragged shard (T_l = 1 and odd extents), 8^4 on 2 x 2, t split
# four ways with z wrapped in the kernel, and one rank (nt = 1: the t
# ghosts are the shard's own signed wrap planes)
DIST_CASES = [((2, 6, 3, 10), (2, 2)), ((8, 8, 8, 8), (2, 2)), ((8, 4, 4, 4), (4, 1)),
              ((8, 8, 8, 8), (4, 1)), ((4, 6, 4, 4), (1, 1))]


@pytest.mark.parametrize("dims,sizes", DIST_CASES, ids=lambda v: "x".join(map(str, v)))
@pytest.mark.parametrize("rows,ldt", [(2, torch.float32), (3, torch.bfloat16)])
def test_dist_kernels(dev, dims, sizes, rows, ldt):
    """B14 and B15 on every rank against their plain versions, with the
    ghosts received from the real neighbours (alpha != 0)."""
    from mgpgcr_tpu_torch import ShardLocalWilsonDirac, make_shard_grid, run_spmd, shard_field
    from mgpgcr_tpu_torch.kernels.dslash_dist import dslash_dist, dslash_dist_plain, psi_ghosts
    from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import (
        gcr_stream_step_dist,
        gcr_stream_step_dist_plain,
        step_ghosts,
    )

    S = 3
    mesh = LatticeMesh((*dims, 4, 3))
    canon = wilson.random_links_np(1, mesh)
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (4, 3, dims[0], dims[1], dims[2] * dims[3])
    psi = cplx.random(gen, shape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    k = torch.tensor(0.13 - 0.02j, dtype=torch.complex64, device=dev)
    alpha = torch.tensor(0.4 + 0.1j, dtype=torch.complex64, device=dev)
    grid = make_shard_grid(sizes, ("t", "z"), device=dev)

    def rank(comm):
        d = ShardLocalWilsonDirac.build(canon, mesh, comm, "t", "z", compress=rows == 2,
                                        antiperiodic_t=True, link_dtype=ldt)
        x = shard_field(psi, grid, comm.rank, "t", "z")
        ap = shard_field(aps, grid, comm.rank, "t", "z")
        g = psi_ghosts(x, comm, "t", "z", True, d.ghost_links)
        for kk in (None, k):
            _close(dslash_dist(d.links, x, d.local_mesh, g, kk),
                   dslash_dist_plain(d.links, x, d.local_mesh, g, kk))
        for lim in (1, S):
            gs = step_ghosts(x, ap, alpha, lim, comm, "t", "z", True, d.ghost_links)
            got = gcr_stream_step_dist(d.links, x, ap, alpha, k, lim, d.local_mesh, gs)
            want = gcr_stream_step_dist_plain(d.links, x, ap, alpha, k, lim, d.local_mesh, gs)
            for gg, ww in zip(got, want):
                _close(gg, ww)
        torch.cuda.synchronize()

    before = dslash_dist.launches
    run_spmd(grid, rank)
    assert dslash_dist.launches == before + 2 * grid.size


@pytest.mark.parametrize("S", [5, 20])
@pytest.mark.parametrize("rows,ldt", STEP_LINKS, ids=lambda v: str(v))
def test_dist_step_kernel(dev, S, rows, ldt):
    """B15 at every lim from 1 to S on each rank of a (2, 2) grid over the
    ragged 2x6x3x10 lattice (one t-plane a shard) against its plain
    version, alpha != 0, with the ghosts received from the neighbours."""
    from mgpgcr_tpu_torch import ShardLocalWilsonDirac, make_shard_grid, run_spmd, shard_field
    from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import (
        gcr_stream_step_dist,
        gcr_stream_step_dist_plain,
        step_ghosts,
    )

    dims = (2, 6, 3, 10)
    mesh = LatticeMesh((*dims, 4, 3))
    canon = wilson.random_links_np(1, mesh)
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (4, 3, dims[0], dims[1], dims[2] * dims[3])
    r = cplx.random(gen, shape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    k = torch.tensor(0.13 - 0.02j, dtype=torch.complex64, device=dev)
    alpha = torch.tensor(-0.3 + 0.2j, dtype=torch.complex64, device=dev)
    grid = make_shard_grid((2, 2), ("t", "z"), device=dev)

    def rank(comm):
        d = ShardLocalWilsonDirac.build(canon, mesh, comm, "t", "z", compress=rows == 2,
                                        antiperiodic_t=True, link_dtype=ldt)
        x = shard_field(r, grid, comm.rank, "t", "z")
        ap = shard_field(aps, grid, comm.rank, "t", "z")
        for lim in range(1, S + 1):
            gs = step_ghosts(x, ap, alpha, lim, comm, "t", "z", True, d.ghost_links)
            got = gcr_stream_step_dist(d.links, x, ap, alpha, k, lim, d.local_mesh, gs)
            want = gcr_stream_step_dist_plain(d.links, x, ap, alpha, k, lim, d.local_mesh, gs)
            for gg, ww in zip(got, want):
                _close(gg, ww)
            assert bool((got[3][lim:] == 0).all()) and bool((got[4][lim:S] == 0).all())
        torch.cuda.synchronize()

    before = gcr_stream_step_dist.launches
    run_spmd(grid, rank)
    assert gcr_stream_step_dist.launches == before + S * grid.size


def test_dist_solve(dev):
    """The domain-decomposed fused restart-5 solve at 8^4 on a 2 x 2 grid of
    ThreadComm ranks against the single-device fused solve: B15 launched,
    K1 and K2 not."""
    from mgpgcr_tpu_torch import gcr_solve_grid, kernels, make_shard_grid

    mesh = LatticeMesh((8, 8, 8, 8, 4, 3))
    canon = wilson.random_links_np(3, mesh)
    d = CudaWilsonDirac.build(canon, mesh, compress=True, antiperiodic_t=True, device=dev)
    a = DiracOperator(d, 0.12)
    b = cplx.random(torch.Generator(device=dev).manual_seed(5), d.field_shape, device=dev)
    params = GCRParams(tol=1e-6, max_iter=200, restart=5, fused=True)
    ref = gcr_solve(a, b, params)
    kernels.reset_launches()
    res = gcr_solve_grid(canon, mesh, 0.12, b, params, make_shard_grid((2, 2), device=dev),
                         "t", "z", compress=True, antiperiodic_t=True)
    counts = kernels.launch_counts()
    rr = b - a.apply(res.x)
    assert res.converged and abs(res.n_iters - ref.n_iters) <= 1
    assert float(torch.sqrt(cplx.abs2_sum(rr) / cplx.abs2_sum(b))) < 2e-6
    assert counts["gcr_stream_step_dist"] > 0 and counts["dslash_dist"] > 0
    assert counts["gcr_stream_step"] == 0 and counts["dslash_apply"] == 0


# The even-odd paths' shapes: half-size fields (4, 3, T, Z, Y*X/2) of the
# Schur solves and the half mesh's (b, b, b, b/2) blocks of its MG.
HALF_MESH = (8, 8, 8, 8)  # the half mesh of an 8x8x8x16 lattice


@pytest.mark.parametrize("b", [2, 4, 8])
def test_half_mesh_transfers(dev, b):
    mesh_h = LatticeMesh((*HALF_MESH, 4, 3))
    bm = mesh_h.blocking((b, b, b, max(b // 2, 1)))
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (4, 3, HALF_MESH[0], HALF_MESH[1], HALF_MESH[2] * HALF_MESH[3])
    ne = 6
    x = cplx.random(gen, shape, torch.float32, dev)
    q = cplx.random(gen, (ne,) + shape, torch.float32, dev)
    xc = cplx.random(gen, (bm.n_blocks * ne,), torch.float32, dev)
    for qf in (q, q.astype(torch.bfloat16)):
        _close(restrict(qf, bm, x), restrict_plain(qf, bm, x))
        _close(prolong(qf, bm, xc, x, 0.7), prolong_plain(qf, bm, xc, x, 0.7))


def test_half_field_gcr_kernels(dev):
    S = 5
    gen = torch.Generator(device=dev).manual_seed(4)
    shape = (4, 3, 8, 8, 8 * 4)  # the even half of 8^4
    r = cplx.random(gen, shape, torch.float32, dev)
    az = cplx.random(gen, shape, torch.float32, dev)
    aps = cplx.random(gen, (S,) + shape, torch.float32, dev)
    alpha = torch.tensor(0.4 + 0.1j, dtype=torch.complex64, device=dev)
    betas = torch.complex(torch.rand(S, generator=gen, device=dev),
                          torch.rand(S, generator=gen, device=dev))
    for lim in range(1, S + 1):
        slot = lim % S
        for g, w in zip(update_r(r, aps, lim - 1, alpha), update_r_plain(r, aps, lim - 1, alpha)):
            _close(g, w)
        _close(beta_dots(aps, az, lim)[:lim], beta_dots_plain(aps, az, lim)[:lim])
        got = ap_update(az, aps.clone(), betas, slot, lim, r=r)
        want = ap_update_plain(az, aps.clone(), betas, slot, lim, r=r)
        for g, w in zip(got, want):
            _close(g, w)
        basis = [aps[m] for m in range(lim)] + [r]
        w = betas[: lim + 1] if lim < S else torch.cat([betas, betas[:1]])
        for g, ww in zip(basis_flush(r, basis, w, w.conj()),
                         basis_flush_plain(r, basis, w, w.conj())):
            _close(g, ww)


def test_eo_paths_on_card(dev):
    from mgpgcr_tpu_torch import EvenOddWilson, eo_solve, setup_eo_mg
    from mgpgcr_tpu_torch import kernels

    mesh = LatticeMesh((8, 8, 8, 16, 4, 3))
    links = wilson.random_links_np(6, mesh)
    d = CudaWilsonDirac.build(links, mesh, antiperiodic_t=True, device=dev)
    eo = EvenOddWilson.from_dirac(d)
    b = cplx.random(torch.Generator(device=dev).manual_seed(7), d.field_shape, torch.float32,
                    dev)
    params = GCRParams(tol=1e-6, max_iter=300, restart=5, fused=True)
    kernels.reset_launches()
    plain = eo_solve(eo, 0.12, b, params)
    assert plain.converged and kernels.launch_counts()["ap_update"] > 0
    _, mgp = setup_eo_mg(torch.Generator(device=dev).manual_seed(3), eo, 0.12,
                         MGParams(block=4, n_nullvecs=2))
    kernels.reset_launches()
    res = eo_solve(eo, 0.12, b, GCRParams(tol=1e-6, max_iter=100, restart=5, fused=True,
                                          unroll="cycles"), precond=mgp.apply)
    counts = kernels.launch_counts()
    assert res.converged and res.n_iters < plain.n_iters
    assert counts["restrict"] > 0 and counts["prolong"] > 0 and counts["update_r"] > 0
    for x in (plain.x, res.x):
        r = b - DiracOperator(d, 0.12).apply(x)
        assert float(torch.sqrt(cplx.abs2_sum(r) / cplx.abs2_sum(b))) < 2e-6


def test_heatbath_sweep_cuda_matches_cpu(dev):
    from mgpgcr_tpu_torch import gauge

    mesh = LatticeMesh((4, 4, 4, 4, 4, 3))
    links = torch.as_tensor(wilson.random_links_np(5, mesh))

    def sampler():  # the same draws for both runs, made on the CPU
        g = torch.Generator().manual_seed(9)

        def sample(mu, parity, idx, alpha):
            h0, _ = gauge.kp_sample(g, alpha.cpu())
            return gauge.random_su2_from_h0(g, h0, torch.complex128)

        return sample

    cpu = gauge.sweep(None, links, 6.0, n_or=2, sampler=sampler())
    gpu = gauge.sweep(None, links.to(dev), 6.0, n_or=2, sampler=sampler())
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-10)
    u64, _ = gauge.thermalized_links(1, mesh, n_sweeps=3, n_or=1, device=dev)
    uni, det = gauge.unitarity_error(u64)
    assert u64.device.type == "cuda" and uni < 2e-6 and det < 2e-6
