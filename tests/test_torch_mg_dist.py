"""The port's sharded MG setup and V-cycle (``solvers/mg_dist.py``) against
the JAX package's single-device ``setup_mg`` on the same start vector: the
contract of the JAX package's own tests/test_mg_dist.py (same b0 => the
same near-null space, Galerkin operator and V-cycle, up to the rounding
of the summed reductions). No JAX ``setup_mg_sharded`` or
``mg_gcr_solve_sharded`` runs here.

float64, CPU, 4^4 lattice, k = 0.12, anti-periodic t, two-row links on the
port's side (``ShardLocalWilsonDirac``: B14/B15's plain versions), block 2,
one near-null vector (ne = 2), a short setup, the smoother off (JAX's
V-cycle with a smoother takes seconds per apply off the TPU), coarse GCR
to 1e-10. Ranks are threads (``ThreadComm``) on (2, 1) and (2, 2) (t, z)
grids; the interpreter's switch interval is shortened while they run (the
ranks hand the lock to each other at every exchange), as the python guide
advises for tests of threads. The JAX setup's compile dominates.

- The gathered coarse operator (dense format) equals JAX's coarse matrix,
  and the block-stencil rows the same blocks, to 1e-10 of scale.
- The gathered basis spans JAX's per block (the bases agree to 1e-10 up
  to the sign MGS and QR may pick per column: P P^H equal).
- One V-cycle on the same input, gathered, equals JAX's apply to 1e-10 of
  scale, with the replicated dense coarse solve and with the shard-local
  stencil coarse solve.
- A block extent that does not divide the shard raises.
- The port's ``solve --mg`` against the JAX CLI's (both in-process, the
  same lattice size, dtype and MG parameters, from one JSON config): the
  same right-hand side and MG start vector on both sides (one numpy draw
  sequence injected into both packages' ``cplx.random``), the same outer
  iteration count, final relative residuals within 1e-10 of each other,
  independent residuals at the tolerance, and one "timer" event for the
  setup in each run log. It lives here, with the reference above, because
  the JAX CLI's setup compiles the same programs as the reference's
  ``setup_mg``: one process compiles them once.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.wilson import antiperiodic_t as j_antiperiodic_t
from mgpgcr_tpu.ops.wilson_tpu import TpuWilsonDirac
from mgpgcr_tpu.solvers.mg import setup_mg as j_setup_mg
from mgpgcr_tpu.solvers.params import GCRParams as JGCRParams
from mgpgcr_tpu.solvers.params import MGParams as JMGParams
from mgpgcr_tpu_torch import (
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    ShardLocalWilsonDirac,
    cplx,
    gather_field,
    make_shard_grid,
    run_spmd,
    setup_mg_sharded,
    shard_field,
)
from mgpgcr_tpu_torch.ops.wilson import random_links_np
from mgpgcr_tpu_torch.solvers.mg_dist import ShardLocalCoarseStencil
from torch_cli_helpers import inject_draws, run_both

K = 0.12
DIMS = (4, 4, 4, 4)
TOL = 1e-10
SETUP = dict(block=2, n_nullvecs=1, setup_power_iters=1)
SETUP_GCR = dict(tol=1e-6, max_iter=3, restart=3)
COARSE_GCR = dict(tol=1e-10, max_iter=40, restart=10)


@pytest.fixture(autouse=True)
def thread_ranks():
    """Ranks as threads of one process: a short switch interval and one
    intra-op thread each, restored after the test."""
    old, old_threads = sys.getswitchinterval(), torch.get_num_threads()
    sys.setswitchinterval(1e-4)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        sys.setswitchinterval(old)
        torch.set_num_threads(old_threads)


@pytest.fixture(scope="module")
def reference():
    """JAX's single-device hierarchy and its V-cycle on a fixed input."""
    mesh = JMesh((*DIMS, 4, 3))
    links = random_links_np(3, mesh)
    jd = TpuWilsonDirac.build(jcplx.ascf(jnp.asarray(j_antiperiodic_t(links)), jnp.float64),
                              mesh)
    ja = JDirac(jd, jcplx.from_scalar(K, jnp.float64))
    params = JMGParams(**SETUP, setup_gcr=JGCRParams(**SETUP_GCR),
                       coarse_gcr=JGCRParams(**COARSE_GCR), smoother_gcr=None)
    mgp = j_setup_mg(jax.random.PRNGKey(3), ja, mesh, params, layout="tpu")
    b0 = jcplx.to_numpy(jcplx.random(jax.random.PRNGKey(3), jd.field_shape, jnp.float64))
    r = np.random.default_rng(9).standard_normal((2,) + jd.field_shape)
    r = r[0] + 1j * r[1]
    # jitted: one compile of the V-cycle instead of one per eager operation
    vcycle = jcplx.to_numpy(jax.jit(mgp.apply)(jcplx.ascf(jnp.asarray(r), jnp.float64)))
    q = jcplx.to_numpy(mgp.q)  # (ne, nb, bl)
    return dict(links=links, b0=b0, r=r, vcycle=vcycle, coarse=jcplx.to_numpy(mgp.coarse.a),
                projector=np.einsum("ebk,ebl->bkl", q, q.conj()))


def _port_params(fmt):
    return MGParams(**SETUP, setup_gcr=GCRParams(**SETUP_GCR),
                    coarse_gcr=GCRParams(**COARSE_GCR), smoother_gcr=None, coarse_format=fmt)


def _sharded(reference, sizes, fmt):
    """Per rank: the setup on this rank's shard, its gathered pieces and
    the V-cycle of the reference input."""
    grid = make_shard_grid(sizes, ("t", "z"), device="cpu")
    mesh = LatticeMesh((*DIMS, 4, 3))
    b0 = cplx.from_numpy(reference["b0"], torch.float64, "cpu")
    r = cplx.from_numpy(reference["r"], torch.float64, "cpu")

    def rank(comm):
        d = ShardLocalWilsonDirac.build(reference["links"], mesh, comm, "t", "z", compress=True,
                                        antiperiodic_t=True, link_dtype=torch.float64)
        a = DiracOperator(d, torch.tensor(K, dtype=torch.complex128))
        mgp = setup_mg_sharded(torch.Generator().manual_seed(3), a, _port_params(fmt), b0=b0)
        y = mgp.apply(shard_field(r, grid, comm.rank, "t", "z"))
        coarse = mgp.coarse
        blocks = (mgp.geom.gather_blocked(coarse.blocks, comm)
                  if isinstance(coarse, ShardLocalCoarseStencil) else None)
        return mgp, y, blocks

    out = run_spmd(grid, rank, timeout=120)
    return grid, out


@pytest.mark.parametrize("sizes", [(2, 1), (2, 2)])
def test_hierarchy_and_vcycle_match_single_device(reference, sizes):
    grid, out = _sharded(reference, sizes, "dense")
    mgp = out[0][0]
    scale = np.abs(reference["coarse"]).max()
    assert np.abs(mgp.coarse.a.numpy() - reference["coarse"]).max() <= TOL * scale
    # the gathered basis spans the same per-block spaces
    q5 = [o[0].q5 for o in out]
    from mgpgcr_tpu_torch.parallel.mesh import join_shards

    q = cplx.to_numpy(join_shards(q5, grid, {"t": 1, "z": 2}))
    q = q.reshape(q.shape[0], -1, q.shape[-1])
    proj = np.einsum("ebk,ebl->bkl", q, q.conj())
    assert np.abs(proj - reference["projector"]).max() <= TOL
    y = cplx.to_numpy(gather_field([o[1] for o in out], grid, "t", "z"))
    assert np.abs(y - reference["vcycle"]).max() <= TOL * np.abs(reference["vcycle"]).max()


def test_shard_local_stencil_coarse_matches_single_device(reference):
    grid, out = _sharded(reference, (2, 2), "stencil")
    blocks = out[0][2].numpy()  # (Bt, Bz, By*Bx, 9, ne, ne), global row-major
    assert blocks.shape == (2, 2, 4, 9, 2, 2)
    # the stencil's dense form is JAX's coarse matrix
    from mgpgcr_tpu_torch.solvers.mg import blocks_to_dense

    table = LatticeMesh((*DIMS, 4, 3)).blocking(2).neighbor_table()
    dense = blocks_to_dense(torch.as_tensor(blocks.reshape(16, 9, 2, 2)), table).numpy()
    scale = np.abs(reference["coarse"]).max()
    assert np.abs(dense - reference["coarse"]).max() <= TOL * scale
    y = cplx.to_numpy(gather_field([o[1] for o in out], grid, "t", "z"))
    assert np.abs(y - reference["vcycle"]).max() <= TOL * np.abs(reference["vcycle"]).max()


def test_blocks_may_not_straddle_shards(reference):
    mesh = LatticeMesh((*DIMS, 4, 3))
    grid = make_shard_grid((2, 2), ("t", "z"), device="cpu")

    def rank(comm):
        d = ShardLocalWilsonDirac.build(reference["links"], mesh, comm, "t", "z",
                                        link_dtype=torch.float64)
        setup_mg_sharded(torch.Generator().manual_seed(3), DiracOperator(d, K),
                         MGParams(block=4))

    with pytest.raises(ValueError, match="divide the PER-SHARD lattice"):
        run_spmd(grid, rank, timeout=60)


def test_mg_solve_matches_jax(tmp_path, capsys, monkeypatch):
    draws = inject_draws(monkeypatch)
    mg = {**SETUP, "setup_gcr": SETUP_GCR, "coarse_gcr": COARSE_GCR, "smoother_gcr": None}
    (tmp_path / "mg.json").write_text(json.dumps({"mg": mg}))
    argv = ["solve", "--platform", "cpu", "--dtype", "cf64", "--lattice", *map(str, DIMS),
            "--k", str(K), "--antiperiodic", "--tol", "1e-10", "--config",
            str(tmp_path / "mg.json")]
    (rc_p, out_p), (rc_j, out_j) = run_both(argv + ["--log", str(tmp_path / "p.jsonl")],
                                            argv + ["--log", str(tmp_path / "j.jsonl")], capsys)
    assert rc_p == rc_j == 0
    assert draws[0].n == draws[1].n == 2  # the right-hand side and the MG start vector
    assert out_p["iters"] == out_j["iters"] and out_p["mg_setup_s"] > 0
    assert abs(out_p["relres"] - out_j["relres"]) <= 1e-10
    assert out_p["indep_relres"] <= 1e-10 * 1.01
    for name in ("p", "j"):
        events = [json.loads(x) for x in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        assert [e["name"] for e in events if e["event"] == "timer"] == ["mg_setup", "solve"]
        assert events[-1]["event"] == "result"
