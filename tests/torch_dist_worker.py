"""One rank of the two-process gloo solve in test_torch_gcr_dist.py, and
the per-rank solve it shares with that test's ThreadComm run. Imports no
JAX. Run as a process:

    python tests/torch_dist_worker.py PROBLEM.npz INIT_FILE RANK WORLD OUT.npz THREADS
"""

import sys

import numpy as np
import torch

from mgpgcr_tpu_torch import (
    DiracOperator,
    GCRParams,
    LatticeMesh,
    ShardLocalWilsonDirac,
    cplx,
    gcr_solve_sharded,
    shard_field,
)

PARAMS = GCRParams(tol=1e-10, max_iter=120, restart=5, fused=True)


def solve_rank(comm, problem: dict):
    """This rank's part of the solve of the problem in ``problem`` (numpy
    arrays: dims, links, rhs, k) on a t-only grid."""
    mesh = LatticeMesh(tuple(int(d) for d in problem["dims"]))
    d = ShardLocalWilsonDirac.build(problem["links"], mesh, comm, "t", None, compress=True,
                                    antiperiodic_t=True, link_dtype=torch.float64)
    rhs = cplx.from_numpy(problem["rhs"], torch.float64, "cpu")
    b = shard_field(rhs, comm.grid, comm.rank, "t", None)
    return gcr_solve_sharded(DiracOperator(d, complex(problem["k"])), b, PARAMS, comm)


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
