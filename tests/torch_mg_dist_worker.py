"""One rank of the two-process gloo run of the sharded MG setup and solve in
test_torch_mg_dist_solve.py, and the per-rank body it shares with that
test's ThreadComm run. Imports no JAX. Run as a process:

    python tests/torch_mg_dist_worker.py PROBLEM.npz INIT_FILE RANK WORLD OUT.npz THREADS
"""

import sys

import numpy as np
import torch

from mgpgcr_tpu_torch import (
    DiracOperator,
    GCRParams,
    LatticeMesh,
    MGParams,
    ShardLocalWilsonDirac,
    cplx,
    mg_gcr_solve_sharded,
    setup_mg_sharded,
    shard_field,
)
from mgpgcr_tpu_torch.ops.wilson import random_links_np

MG = MGParams(block=2, n_nullvecs=1, setup_power_iters=1,
              setup_gcr=GCRParams(tol=1e-6, max_iter=3, restart=3),
              coarse_gcr=GCRParams(tol=1e-3, max_iter=10, restart=10),
              smoother_gcr=GCRParams(tol=0.0, max_iter=2, restart=2, fused=True))
OUTER = GCRParams(tol=1e-10, max_iter=60, restart=5, fused=True)


def make_problem(dims=(4, 4, 4, 4), k: float = 0.12) -> dict:
    """The shared problem of the sharded MG tests (numpy arrays): links of
    seed 3, a start vector ``b0`` and a right-hand side from numpy seed 11."""
    mesh = LatticeMesh((*dims, 4, 3))
    rng = np.random.default_rng(11)
    shape = (4, 3, dims[0], dims[1], dims[2] * dims[3])
    b0, rhs = (rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape) for _ in range(2))
    return dict(dims=np.asarray(mesh.dims), links=random_links_np(3, mesh), b0=b0, rhs=rhs,
                k=np.asarray(k))


def rank_setup(problem: dict, comm, axis_z, mg: MGParams):
    """This rank's sharded MG setup of ``problem`` on a (t, ``axis_z``) grid."""
    mesh = LatticeMesh(tuple(int(d) for d in problem["dims"]))
    d = ShardLocalWilsonDirac.build(problem["links"], mesh, comm, "t", axis_z, compress=True,
                                    antiperiodic_t=True, link_dtype=torch.float64)
    a = DiracOperator(d, torch.tensor(complex(problem["k"]), dtype=torch.complex128))
    return setup_mg_sharded(torch.Generator().manual_seed(0), a, mg,
                            b0=cplx.from_numpy(problem["b0"], torch.float64, "cpu"))


def solve_rank(comm, problem: dict):
    """This rank's sharded MG setup (start vector ``b0``) and MG-GCR solve of
    the problem in ``problem`` (numpy arrays: dims, links, b0, rhs, k) on a
    t-only grid."""
    mgp = rank_setup(problem, comm, None, MG)
    rhs = cplx.from_numpy(problem["rhs"], torch.float64, "cpu")
    return mg_gcr_solve_sharded(shard_field(rhs, comm.grid, comm.rank, "t", None), OUTER, mgp)


def main(argv) -> None:
    from mgpgcr_tpu_torch.parallel import TorchDistComm, init_distributed, make_shard_grid

    path, init_file, rank, world, out, threads = argv
    torch.set_num_threads(int(threads))
    problem = dict(np.load(path))
    init_distributed(f"file://{init_file}", int(world), int(rank), device="cpu")
    comm = TorchDistComm(make_shard_grid((int(world),), ("t",), device="cpu"), device="cpu")
    res = solve_rank(comm, problem)
    np.savez(out, x_re=res.x.re.numpy(), x_im=res.x.im.numpy(),
             hist=res.res_history.numpy(), n_iters=res.n_iters)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
