"""The driver and the sharded paths of the port on the card: the command
line's solves launch their kernels, and the sharded MG runs B10, B11, B14
and B15 at its shard shapes, each against its plain version. Skips
without a CUDA device. On the card, without JAX installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_driver.py``."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    ShardLocalWilsonDirac,
    cli,
    cplx,
    gather_field,
    gcr_solve,
    kernels,
    make_shard_grid,
    mg_gcr_solve_sharded,
    run_spmd,
    setup_mg,
    setup_mg_sharded,
    shard_field,
)
from mgpgcr_tpu_torch.kernels import transfer
from mgpgcr_tpu_torch.kernels.dslash_dist import dslash_dist, dslash_dist_plain, psi_ghosts
from mgpgcr_tpu_torch.kernels.gcr_dslash_dist import (
    gcr_stream_step_dist,
    gcr_stream_step_dist_plain,
    step_ghosts,
)
from mgpgcr_tpu_torch.ops.wilson import random_links_np

pytestmark = pytest.mark.cuda

TOL = 1e-5  # f32 fields, relative to the output's scale
K = 0.12


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    g, w = cplx.to_numpy(got), cplx.to_numpy(want)
    np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("extra,launched", [
    ([], ("dslash_apply", "gcr_stream_step", "ap_update", "basis_flush")),
    (["--mg", "--block", "2", "--nullvecs", "2"], ("gcr_z_step", "restrict", "prolong")),
    (["--mg", "--block", "2", "--nullvecs", "2", "--coarse-format", "stencil", "--no-smoother"],
     ("stencil_spmv", "restrict", "prolong")),
    (["--eo"], ("update_r", "beta_dots", "ap_update", "basis_flush")),
])
def test_cli_solve_on_the_card(dev, extra, launched):
    argv = ["solve", "--dtype", "cf32", "--lattice", "8", "8", "8", "8", "--k", str(K),
            "--tol", "1e-6", "--restart", "5", "--fused", "--antiperiodic", *extra]
    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    counts = kernels.launch_counts()
    assert out["converged"] and out["indep_relres"] <= 2e-6
    assert all(counts[k] > 0 for k in launched), counts


@pytest.mark.parametrize("sizes", [(2, 1), (2, 2)])
def test_sharded_mg_kernels_and_solve(dev, sizes):
    mesh = LatticeMesh((8, 8, 8, 8, 4, 3))
    links = random_links_np(3, mesh)
    params = MGParams(block=2, n_nullvecs=2)
    outer = GCRParams(tol=1e-6, max_iter=100, restart=5, fused=True, unroll="cycles")
    a1 = DiracOperator(CudaWilsonDirac.build(links, mesh, compress=True, antiperiodic_t=True,
                                             device=dev), K)
    b = cplx.random(torch.Generator(device=dev).manual_seed(1), (4, 3, 8, 8, 64), torch.float32,
                    dev)
    ref = gcr_solve(a1, b, outer, precond=setup_mg(torch.Generator(device=dev).manual_seed(3),
                                                   a1, mesh, params).apply)
    grid = make_shard_grid(sizes, ("t", "z"), device=dev)

    def rank(comm):
        d = ShardLocalWilsonDirac.build(links, mesh, comm, "t", "z", compress=True,
                                        antiperiodic_t=True)
        mgp = setup_mg_sharded(torch.Generator(device=dev).manual_seed(3), DiracOperator(d, K),
                               params)
        gen = torch.Generator(device=dev).manual_seed(10 + comm.rank)
        x = cplx.random(gen, d.field_shape, torch.float32, dev)
        lbm = mgp.geom.local_block_map()
        xc = cplx.random(gen, (mgp.q_field.shape[0] * lbm.n_blocks,), torch.float32, dev)
        _close(transfer.restrict(mgp.q_field, lbm, x), transfer.restrict_plain(mgp.q_field, lbm, x))
        _close(transfer.prolong(mgp.q_field, lbm, xc, x, 0.5),
               transfer.prolong_plain(mgp.q_field, lbm, xc, x, 0.5))
        kt = torch.tensor(K, dtype=torch.complex64, device=dev)
        g = psi_ghosts(x, comm, "t", "z", True, d.ghost_links)
        _close(dslash_dist(d.links, x, d.local_mesh, g, kt),
               dslash_dist_plain(d.links, x, d.local_mesh, g, kt))
        aps = cplx.random(gen, (5,) + d.field_shape, torch.float32, dev)
        alpha = torch.tensor(0.3 - 0.2j, dtype=torch.complex64, device=dev)
        gs = step_ghosts(x, aps, alpha, 3, comm, "t", "z", True, d.ghost_links)
        got = gcr_stream_step_dist(d.links, x, aps, alpha, kt, 3, d.local_mesh, gs)
        want = gcr_stream_step_dist_plain(d.links, x, aps, alpha, kt, 3, d.local_mesh, gs)
        _close(got[0], want[0])
        _close(got[1], want[1])
        return mg_gcr_solve_sharded(shard_field(b, grid, comm.rank, "t", "z"), outer, mgp)

    kernels.reset_launches()
    out = run_spmd(grid, rank)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("restrict", "prolong", "dslash_dist",
                                       "gcr_stream_step_dist")), counts
    assert out[0].converged and abs(out[0].n_iters - ref.n_iters) <= 1
    x = gather_field([o.x for o in out], grid, "t", "z")
    r = b - a1.apply(x)
    assert float(torch.sqrt(cplx.abs2_sum(r) / cplx.abs2_sum(b))) <= 2e-6
