"""Port parity for the domain-decomposed fused GCR, the slice as a whole:
the port's ``gcr_solve_sharded`` under ``ThreadComm`` on a (2, 2) grid,
fused (its iterations through the ghost-plane one-pass step) on the main
path's operator (anti-periodic t, two-row links) and generic on periodic
three-row links, against the JAX ``gcr_solve_sharded`` inside
``shard_map`` (interpret mode): same iteration count, histories to rtol
1e-8, x to atol 1e-9, in float64. The JAX side runs restart 2 (its cycles
form unrolls the restart steps into one program: restart 5 compiles for
~65 s on one core); restart 5, the loop form and a grid whose local t
extent declines the one-pass step are held to the port's single-device
solve (itself held to JAX in test_torch_gcr.py) and to the JAX package's
numpy oracle. Two gloo processes under ``TorchDistComm`` give the
ThreadComm run's x and history bit for bit. Each JAX solve is a module
fixture, compiled once."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgpgcr_tpu import cplx as jcplx
from mgpgcr_tpu.mesh import LatticeMesh as JMesh
from mgpgcr_tpu.ops.dirac import DiracOperator as JDirac
from mgpgcr_tpu.ops.pallas.dslash import PallasWilsonDirac
from mgpgcr_tpu.ops.wilson import antiperiodic_t, dirac_apply_np
from mgpgcr_tpu.parallel import make_lattice_device_mesh
from mgpgcr_tpu.solvers.gcr_dist import gcr_solve_sharded as j_gcr_solve_sharded
from mgpgcr_tpu.solvers.params import GCRParams as JParams
from mgpgcr_tpu_torch import (
    CudaWilsonDirac,
    DiracOperator,
    GCRParams,
    LatticeMesh,
    ShardLocalWilsonDirac,
    cplx,
    field_from_slab,
    field_to_slab,
    gcr_solve,
    gcr_solve_grid,
    gcr_solve_sharded,
    gather_field,
    make_shard_grid,
    run_spmd,
    shard_field,
)
from mgpgcr_tpu_torch.ops import wilson
from mgpgcr_tpu_torch.solvers.gcr import _mega_step_config

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DIMS = (4, 4, 2, 2)
K = 0.08
RESTART = 2  # the JAX cycles form unrolls restart steps into its program


@pytest.fixture(scope="module", autouse=True)
def _quick_compile():
    """Each JAX solve here runs once: compile it without XLA's optimisation
    passes (restored after the module)."""
    old = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", old)


@pytest.fixture(scope="module")
def problem():
    mesh = LatticeMesh((*DIMS, 4, 3))
    links = wilson.random_links_np(3, mesh)
    rng = np.random.default_rng(4)
    shape = (4, 3, DIMS[0], DIMS[1], DIMS[2] * DIMS[3])
    rhs = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return mesh, links, rhs


def _params(fused, unroll="auto", restart=RESTART):
    return GCRParams(tol=1e-10, max_iter=120, restart=restart, fused=fused, unroll=unroll)


# (fused, anti-periodic t and two-row links): the fused solve on the main
# path's operator, the generic one on periodic three-row links
@pytest.fixture(scope="module", params=[(True, True), (False, False)],
                ids=["fused", "generic"])
def jax_solve(request, problem):
    """The JAX package's domain-decomposed solve on a (2, 2) grid."""
    mesh, links, rhs = problem
    fused, anti = request.param
    dmesh = make_lattice_device_mesh(4, axis_names=("t", "z"), axis_sizes=(2, 2))
    d = PallasWilsonDirac.build_sharded(jcplx.ascf(jnp.asarray(links), jnp.float64),
                                        JMesh(mesh.dims), dmesh, axis_t="t", axis_z="z",
                                        compress=anti, antiperiodic_t=anti, interpret=True)
    a = JDirac(d, jcplx.from_scalar(K, jnp.float64))
    params = JParams(tol=1e-10, max_iter=120, restart=RESTART, fused=fused)
    b = jcplx.CF(jnp.asarray(rhs.real), jnp.asarray(rhs.imag))
    res = jax.jit(lambda r: j_gcr_solve_sharded(a, r, params))(d.shard_field(b))
    return fused, anti, res


def _rhs(problem):
    return cplx.from_numpy(problem[2], torch.float64, "cpu")


def _close(res, ref_iters, ref_hist, ref_x):
    assert res.converged and res.n_iters == ref_iters
    n = ref_iters + 1
    np.testing.assert_allclose(res.res_history[:n].numpy(), ref_hist[:n], rtol=1e-8)
    np.testing.assert_allclose(cplx.to_numpy(res.x), ref_x, atol=1e-9)


def _relres(problem, x, anti: bool) -> float:
    """||b - A x|| / ||b|| through the JAX package's numpy oracle."""
    mesh, links, rhs = problem
    lk = antiperiodic_t(links) if anti else links
    xc = field_from_slab(torch.as_tensor(cplx.to_numpy(x)), mesh).numpy()
    bc = field_from_slab(torch.as_tensor(rhs), mesh).numpy()
    return float(np.linalg.norm(bc - dirac_apply_np(lk, JMesh(mesh.dims), xc, K))
                 / np.linalg.norm(bc))


def test_sharded_solve_matches_jax(problem, jax_solve):
    fused, anti, jres = jax_solve
    mesh, links, _ = problem
    grid = make_shard_grid((2, 2), ("t", "z"), device="cpu")
    b = _rhs(problem)

    def rank(comm):
        d = ShardLocalWilsonDirac.build(links, mesh, comm, "t", "z", compress=anti,
                                        antiperiodic_t=anti, link_dtype=torch.float64)
        a = DiracOperator(d, K)
        # the fused form takes the ghost-plane one-pass step (B15) here
        assert _mega_step_config(a, None) is not None
        return gcr_solve_sharded(a, shard_field(b, grid, comm.rank, "t", "z"),
                                 _params(fused), comm)

    res = run_spmd(grid, rank)
    x = gather_field([r.x for r in res], grid, "t", "z")
    # every rank took the same branches: the same scalars to the bit
    h0 = res[0].res_history.numpy()
    assert all(r.n_iters == res[0].n_iters
               and np.array_equal(r.res_history.numpy(), h0, equal_nan=True) for r in res)
    got = type(res[0])(x, res[0].converged, res[0].n_iters, res[0].final_relres,
                       res[0].res_history)
    _close(got, int(jres.n_iters), np.asarray(jres.res_history), jcplx.to_numpy(jres.x))
    assert _relres(problem, x, anti) < 1e-9


@pytest.mark.parametrize("sizes,axis_z,unroll", [
    ((2, 2), "z", "auto"),   # cycles form, B15
    ((2, 2), "z", "loop"),   # loop form on direction stacks: B14 for A z
    ((4, 1), "z", "auto"),   # local T = 1: no one-pass step, B14 and update_r
    ((4,), None, "auto"),    # t-only grid
])
def test_antiperiodic_two_row_matches_single_device(problem, sizes, axis_z, unroll):
    mesh, links, _ = problem
    b = _rhs(problem)
    params = _params(True, unroll, restart=5)
    d1 = CudaWilsonDirac.build(links, mesh, compress=True, antiperiodic_t=True,
                               link_dtype=torch.float64, device="cpu")
    ref = gcr_solve(DiracOperator(d1, K), b, params)
    names = ("t", "z")[: len(sizes)]
    grid = make_shard_grid(sizes, names, device="cpu")
    res = gcr_solve_grid(links, mesh, K, b, params, grid, "t", axis_z, compress=True,
                         antiperiodic_t=True, link_dtype=torch.float64)
    _close(res, ref.n_iters, ref.res_history.numpy(), cplx.to_numpy(ref.x))
    assert _relres(problem, res.x, True) < 1e-9


def test_sharded_solve_from_a_start_vector(problem):
    mesh, links, _ = problem
    b = _rhs(problem)
    x0 = cplx.random(torch.Generator().manual_seed(5), b.shape, torch.float64, "cpu")
    d1 = CudaWilsonDirac.build(links, mesh, link_dtype=torch.float64, device="cpu")
    ref = gcr_solve(DiracOperator(d1, K), b, _params(True), x0=x0)
    res = gcr_solve_grid(links, mesh, K, b, _params(True), make_shard_grid((2, 2), device="cpu"),
                         "t", "z", link_dtype=torch.float64, x0=x0)
    _close(res, ref.n_iters, ref.res_history.numpy(), cplx.to_numpy(ref.x))


def test_sharded_solve_refuses_a_foreign_operator(problem):
    mesh, links, _ = problem
    grid = make_shard_grid((2,), ("t",), device="cpu")
    b = _rhs(problem)
    d1 = CudaWilsonDirac.build(links, mesh, link_dtype=torch.float64, device="cpu")

    def rank(comm):
        return gcr_solve_sharded(DiracOperator(d1, K), shard_field(b, grid, comm.rank),
                                 _params(True), comm)

    with pytest.raises(ValueError, match="ShardLocalWilsonDirac"):
        run_spmd(grid, rank, timeout=10.0)
    with pytest.raises(ValueError, match="does not tile"):
        run_spmd(make_shard_grid((3,), ("t",), device="cpu"),
                 lambda comm: ShardLocalWilsonDirac.build(links, mesh, comm), timeout=10.0)


def test_torch_dist_comm_matches_thread_comm(problem, tmp_path):
    """The same per-rank solve in two gloo processes (TorchDistComm) and as
    two threads (ThreadComm): x and the history equal bit for bit."""
    mesh, links, rhs = problem
    data = {"dims": np.asarray(mesh.dims), "links": links, "rhs": rhs, "k": np.asarray(K)}
    np.savez(tmp_path / "problem.npz", **data)
    grid = make_shard_grid((2,), ("t",), device="cpu")
    threaded = run_spmd(grid, lambda comm: torch_dist_worker.solve_rank(comm, data))

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    worker = Path(torch_dist_worker.__file__)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(tmp_path / "problem.npz"), str(tmp_path / "init"),
         str(r), "2", str(tmp_path / f"out{r}.npz"), str(torch.get_num_threads())],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    for r in range(2):
        out = np.load(tmp_path / f"out{r}.npz")
        res = threaded[r]
        assert int(out["n_iters"]) == res.n_iters and res.converged
        assert np.array_equal(out["x_re"], res.x.re.numpy())
        assert np.array_equal(out["x_im"], res.x.im.numpy())
        assert np.array_equal(out["hist"], res.res_history.numpy(), equal_nan=True)
