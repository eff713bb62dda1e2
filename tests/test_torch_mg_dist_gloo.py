"""The sharded MG setup and MG-GCR solve (``solvers/mg_dist.py``) in two
gloo processes (``TorchDistComm``) against the same per-rank body as two
threads (``ThreadComm``): x and the residual history equal bit for bit.
float64, CPU, 4^4 lattice split over t, the problem and the per-rank body
of ``tests/torch_mg_dist_worker.py``. Imports no JAX."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mgpgcr_tpu_torch import make_shard_grid, run_spmd

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mg_dist_worker as worker  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


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
def problem():
    return worker.make_problem()


def test_torch_dist_comm_matches_thread_comm(problem, tmp_path):
    np.savez(tmp_path / "problem.npz", **problem)
    grid = make_shard_grid((2,), ("t",), device="cpu")
    threaded = run_spmd(grid, lambda comm: worker.solve_rank(comm, problem), timeout=120)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(tmp_path / "problem.npz"), str(tmp_path / "init"),
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
        assert res.converged and int(out["n_iters"]) == res.n_iters
        assert np.array_equal(out["x_re"], res.x.re.numpy())
        assert np.array_equal(out["x_im"], res.x.im.numpy())
        assert np.array_equal(out["hist"], res.res_history.numpy(), equal_nan=True)
