"""Driver entry points of the PyTorch/CUDA port: a one-card solve step and
a multi-rank dry run.

Counterpart of ``__graft_entry__.py``. ``entry()`` returns a solve step on
the main path: the Wilson--Dirac operator A = I - kD on slab fields
(4, 3, T, Z, Y*X), the Dslash kernel K1 (``CudaWilsonDirac``), solved by
flexible GCR (``gcr_solve``).

``dryrun_multichip(n)`` runs the decomposed paths on n ranks, as threads
of this process sharing one device (``parallel/comm.py::run_spmd``; the
per-rank bodies take any communicator, so processes under
``torch.distributed`` run them too):
1. the fused GCR solve on (t, z) shards (the ghost-plane kernels B14 and
   B15, dots summed over ranks), held against the single-device solve;
2. the sharded MG setup and the distributed MG-preconditioned solve with
   the shard-local stencil coarse operator;
3. the even-odd Schur solve on (t, z) shards, its reconstructed x checked
   against the full operator;
4. the plain canonical-layout operator split over (t, z, y)
   (``ShardedWilsonDirac``) under one GCR solve;
5. for n >= 4, a data-parallel axis over stacked right-hand sides on top
   of the (t, z) split.

Run: ``python3 __graft_entry_cuda__.py [n]`` (the card; ``--cpu`` for the
CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mgpgcr_tpu_torch import cplx
from mgpgcr_tpu_torch.mesh import LatticeMesh
from mgpgcr_tpu_torch.ops.base import FunctionOperator
from mgpgcr_tpu_torch.ops.dirac import DiracOperator
from mgpgcr_tpu_torch.ops.dslash import CudaWilsonDirac
from mgpgcr_tpu_torch.ops.wilson import random_links_np
from mgpgcr_tpu_torch.parallel import balanced_factors, make_shard_grid, run_spmd
from mgpgcr_tpu_torch.solvers.gcr import gcr_solve
from mgpgcr_tpu_torch.solvers.params import GCRParams


def entry(device=None):
    """(fn, example_args): the solve step on one device (CUDA unless named)."""
    dev = cplx.resolve_device(device)
    mesh = LatticeMesh((8, 8, 8, 8, 4, 3))
    d = CudaWilsonDirac.build(random_links_np(0, mesh), mesh, device=dev)
    a = DiracOperator(d, 0.12)
    rhs = cplx.random(torch.Generator(device=dev).manual_seed(1), d.field_shape,
                      torch.float32, dev)
    params = GCRParams(tol=1e-5, max_iter=10, restart=5)

    def step(a, rhs):
        res = gcr_solve(a, rhs, params)
        return res.x, res.final_relres

    return step, (a, rhs)


def _relres(a, b, x) -> float:
    r = b - a.apply(x)
    return float(torch.sqrt(cplx.abs2_sum(r) / cplx.abs2_sum(b)))


def _dryrun_fused(n: int, dev) -> None:
    """The fused solve on (t, z) shards, held against the same fused solve
    on one device: a wrong halo or a diverging solve fails, not only a NaN."""
    from mgpgcr_tpu_torch.solvers.gcr_dist import gcr_solve_grid

    st, sz = balanced_factors(n, 2)
    lattice = LatticeMesh((2 * st, 2 * sz, 2, 2, 4, 3))
    links = random_links_np(0, lattice)
    rhs = cplx.random(torch.Generator(device=dev).manual_seed(1),
                      (4, 3, 2 * st, 2 * sz, 4), torch.float32, dev)
    params = GCRParams(tol=1e-4, max_iter=6, restart=6, fused=True)
    res = gcr_solve_grid(links, lattice, 0.1, rhs, params,
                         make_shard_grid((st, sz), ("t", "z"), device=dev), "t", "z")
    a1 = DiracOperator(CudaWilsonDirac.build(links, lattice, device=dev), 0.1)
    ref = gcr_solve(a1, rhs, params)
    assert res.x.shape == rhs.shape
    assert abs(res.final_relres - ref.final_relres) <= 1e-3 + 0.05 * ref.final_relres, (
        res.final_relres, ref.final_relres)
    np.testing.assert_allclose(cplx.to_numpy(res.x), cplx.to_numpy(ref.x), rtol=2e-3, atol=2e-3)


def _dryrun_sharded_mg(n: int, dev) -> None:
    """Sharded MG setup and the distributed MG-GCR solve, the coarse level a
    shard-local stencil (no gather, a distributed coarse solve)."""
    from mgpgcr_tpu_torch.solvers.mg_dist import mg_gcr_solve_grid
    from mgpgcr_tpu_torch.solvers.params import MGParams

    st, sz = balanced_factors(n, 2)
    lattice = LatticeMesh((2 * st, 2 * sz, 2, 2, 4, 3))
    rhs = cplx.random(torch.Generator(device=dev).manual_seed(1),
                      (4, 3, 2 * st, 2 * sz, 4), torch.float32, dev)
    mg_params = MGParams(
        block=2,
        n_nullvecs=1,
        setup_power_iters=1,
        setup_gcr=GCRParams(tol=1e-4, max_iter=3, restart=3),
        coarse_gcr=GCRParams(tol=1e-2, max_iter=5, restart=5),
        smoother_gcr=None,
        coarse_format="stencil",
    )
    res = mg_gcr_solve_grid(random_links_np(0, lattice), lattice, 0.08, rhs,
                            GCRParams(tol=1e-4, max_iter=8, restart=8), mg_params,
                            make_shard_grid((st, sz), ("t", "z"), device=dev), "t", "z")
    assert res.x.shape == rhs.shape
    # a working hierarchy halves the residual well within 8 iterations
    assert res.final_relres < 0.5, res.final_relres


def _dryrun_eo(n: int, dev) -> None:
    """The even-odd Schur solve on (t, z) shards; the reconstructed x must
    solve the full system (a converged half system alone would not catch a
    wrong back-substitution or parity layout)."""
    from mgpgcr_tpu_torch.ops.eo import EvenOddWilson
    from mgpgcr_tpu_torch.solvers.eo import eo_solve_grid

    st, sz = balanced_factors(n, 2)
    lattice = LatticeMesh((2 * st, 2 * sz, 2, 4, 4, 3))
    d = CudaWilsonDirac.build(random_links_np(0, lattice), lattice, device=dev)
    b = cplx.random(torch.Generator(device=dev).manual_seed(2), d.field_shape, torch.float32,
                    dev)
    res = eo_solve_grid(EvenOddWilson.from_dirac(d), 0.1, b,
                        GCRParams(tol=1e-4, max_iter=60, restart=8),
                        make_shard_grid((st, sz), ("t", "z"), device=dev))
    assert res.converged, res.final_relres
    rel = _relres(DiracOperator(d, 0.1), b, res.x)
    assert rel < 5e-4, rel


def _canonical_solve(lattice, comm, batch_axis, rhs_global, params):
    """One rank's GCR solve of (I - 0.1 D) x = rhs on the canonical-layout
    ``ShardedWilsonDirac``; fields are split CFs of its complex blocks."""
    from mgpgcr_tpu_torch.parallel.wilson import ShardedWilsonDirac, shard_lattice_field

    d = ShardedWilsonDirac.build(random_links_np(0, lattice), lattice, comm, batch_axis)

    def apply(x):
        dx = cplx.ascf(d.apply(torch.complex(x.re, x.im)))
        return x - cplx.scale_real(dx, 0.1)

    b = cplx.ascf(shard_lattice_field(rhs_global, comm.grid, comm.rank, lattice, batch_axis)
                  .to(comm.device)).contiguous()
    res = gcr_solve(FunctionOperator(apply, lattice.size), b, params, comm=comm)
    assert res.x.shape == b.shape
    assert np.isfinite(res.final_relres)
    return res


def _dryrun_slab(n: int, dev) -> None:
    """The plain canonical-layout operator split over (t, z, y): halo
    exchanges through the communicator, one GCR solve."""
    st, sz, sy = balanced_factors(n, 3)
    lattice = LatticeMesh((2 * st, 2 * sz, 2 * sy, 2, 4, 3))
    g = torch.Generator(device=dev).manual_seed(1)
    rhs = torch.complex(torch.rand(lattice.dims, generator=g, device=dev, dtype=torch.float32),
                        torch.rand(lattice.dims, generator=g, device=dev, dtype=torch.float32))
    grid = make_shard_grid((st, sz, sy), ("t", "z", "y"), device=dev)
    params = GCRParams(tol=1e-4, max_iter=3, restart=3)
    run_spmd(grid, lambda comm: _canonical_solve(lattice, comm, None, rhs, params))


def _dryrun_batched(n: int, dev) -> None:
    """A data-parallel axis over stacked right-hand sides on top of the
    (t, z) split of the canonical layout: one GCR solve of the stack."""
    dp, st, sz = balanced_factors(n, 3)
    lattice = LatticeMesh((2 * st, 2 * sz, 2, 2, 4, 3))
    g = torch.Generator(device=dev).manual_seed(1)
    shape = (2 * dp,) + lattice.dims
    rhs = torch.complex(torch.rand(shape, generator=g, device=dev, dtype=torch.float32),
                        torch.rand(shape, generator=g, device=dev, dtype=torch.float32))
    grid = make_shard_grid((dp, st, sz), ("dp", "t", "z"), device=dev)
    params = GCRParams(tol=1e-4, max_iter=3, restart=3)
    run_spmd(grid, lambda comm: _canonical_solve(lattice, comm, "dp", rhs, params))


def dryrun_multichip(n_devices: int, device=None) -> None:
    dev = cplx.resolve_device(device)
    _dryrun_fused(n_devices, dev)
    _dryrun_sharded_mg(n_devices, dev)
    _dryrun_eo(n_devices, dev)
    _dryrun_slab(n_devices, dev)
    if n_devices >= 4:
        _dryrun_batched(n_devices, dev)


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv[1:]
    counts = [a for a in sys.argv[1:] if a != "--cpu"]
    device = "cpu" if cpu else None
    fn, args = entry(device)
    out = fn(*args)
    print("entry ok:", float(out[1]))
    dryrun_multichip(int(counts[0]) if counts else 4, device)
    print("dryrun ok")
